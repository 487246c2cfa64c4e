// Known-signer (comb) Ed25519 verification on Hopper with the tree
// accumulation and every field multiply's column reduction on the integer
// tensor cores: a team of four lanes a signature in the prepare pass, four
// teams of four lanes splitting one signature's 128 window points in the
// accumulate pass.  The comb tree under MOCHI_SKEW_IMPL=mxu.
//
// Replaces the reference package's comb.verify_comb_prepared with
// impl="tree" (crypto/comb.py:428-472, _tree_accumulate :354) as it runs
// under MOCHI_SKEW_IMPL=mxu, where every rank-2 multiply of the tree's
// additions and of the compare is crypto/field.py:330 _mul_mxu.  The
// arithmetic lives in comb_tree17.cuh (the tree's record, its team-order
// sum and compare over comb17.cuh's row loads and ge25519.cuh's formulas
// over fe17.cuh's field); the multiply is fe17_team.cuh's (this file
// defines MOCHI_FE17_TEAM), which says how a multiply becomes u8 x u8 ->
// s32 MMA products.  The CPU tests compile the same code with g++.  Where
// the reference selects the basepoint rows with a one-hot float32 matmul,
// this kernel loads the row its digit names.
//
// What bounds it: the function is the comb's, so its bound is comb.cu's
// (105,725 integer multiply-adds a signature over the IMAD rate: 0.052 ms
// at 8192 signatures on a 1980 MHz H100).  Bytes: 141 a signature in and
// out, the 268-byte record written and read once, 128 row gathers of 204
// bytes from tables that stay in the 50 MB L2: microseconds.  This layout
// pays more than the bound counts: every multiply is a team call of 57
// m16n8k32 MMAs a warp with its products, splits, folds and shuffles, and
// every lane of a team repeats the curve code.  So a small launch runs at
// the latency of its dependent calls and a large one at their issue rate.
//
// Design.  Two launches on the caller's stream, 64-thread blocks.
//   * The prepare pass: a team of four lanes a signature, 8 a warp, as
//     comb_mxu.cu maps its chain: R's RFC 8032 decode (275 dependent team
//     calls of one multiply) and both scalars' signed recoding into a
//     record of MOCHI_TREE17_RECORD_INTS int32.
//   * The accumulate pass: MOCHI_TREE17_TEAMS = 4 teams a signature, two
//     signatures a warp.  Team k mixed-adds the signer's and the
//     basepoint's entry of each of its windows w = k, k + 4, ..., k + 60
//     to the identity (32 ge_madd of 4 team calls), then 2 levels of
//     complete addition fold the partner team's point, taken by
//     __shfl_down_sync 8 and 4 lanes down, into its own (5 calls each),
//     and team 0 compares the sum with R (1 call): 139 dependent team
//     calls.  With 8 teams (one signature a warp, 3 levels) the chain is
//     80 calls, but a signature holds a whole warp for them: PERF.md has
//     both measured, 4 faster from ~2,752 lanes.
// Both passes take every multiply through fe17_team.cuh: no shared memory,
// no ldmatrix and no warp barrier on the multiply's path.
//
// Convergence.  mma.sync and the shuffles are warp-wide, and a diverged
// warp traps in the multiply, so every lane reaches every team call and
// shuffle: a warp with no signature in the batch leaves before any
// multiply, teams past the batch (the prepare pass's, or the accumulate
// pass's second signature of a warp under 4 teams) recompute signature
// n - 1 and their store is masked, every team computes every level and the
// compare, a row's clip and a digit's negation are selects (comb_row,
// ge_niels_signed), and lane 0 of a signature's first team stores.
#define MOCHI_FE17_TEAM
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe17.cuh"
#include "fe17_team.cuh"
#include "comb_tree17.cuh"

#define MOCHI_TREE_MXU_THREADS 64                                 // 2 warps a block
#define MOCHI_TREE_MXU_PREP_SIGS (MOCHI_TREE_MXU_THREADS / 4)  // signatures a prepare block
#define MOCHI_TREE_MXU_LANES (4 * MOCHI_TREE17_TEAMS)          // lanes a signature, accumulating
#define MOCHI_TREE_MXU_ACC_SIGS (MOCHI_TREE_MXU_THREADS / MOCHI_TREE_MXU_LANES)

__global__ void __launch_bounds__(MOCHI_TREE_MXU_THREADS)
    mochi_comb_tree_mxu_prepare_kernel(const int32_t* __restrict__ y_r,
                                       const int32_t* __restrict__ sign_r,
                                       const uint8_t* __restrict__ s_bytes,
                                       const uint8_t* __restrict__ h_bytes,
                                       int32_t* __restrict__ scratch, int n) {
  const int i = blockIdx.x * MOCHI_TREE_MXU_PREP_SIGS + (threadIdx.x >> 2);  // this team's signature
  if (i - (int)((threadIdx.x & 31) >> 2) >= n) return;  // the whole warp is past the batch
  const int src = i < n ? i : n - 1;
  int32_t yr[17], rec[MOCHI_TREE17_RECORD_INTS];
  uint8_t s[32], h[32];
  for (int k = 0; k < 17; ++k) yr[k] = __ldg(&y_r[(size_t)src * 17 + k]);
  for (int k = 0; k < 32; ++k) {
    s[k] = __ldg(&s_bytes[(size_t)src * 32 + k]);
    h[k] = __ldg(&h_bytes[(size_t)src * 32 + k]);
  }
  comb_tree17_prepare(rec, yr, __ldg(&sign_r[src]), s, h);
  if (i < n && (threadIdx.x & 3) == 0)
    for (int k = 0; k < MOCHI_TREE17_RECORD_INTS; ++k)
      scratch[(size_t)i * MOCHI_TREE17_RECORD_INTS + k] = rec[k];
}

__global__ void __launch_bounds__(MOCHI_TREE_MXU_THREADS)
    mochi_comb_tree_mxu_kernel(const int32_t* __restrict__ table, int64_t rows,
                               const int32_t* __restrict__ key_idx,
                               const int32_t* __restrict__ bcomb,
                               const int32_t* __restrict__ scratch,
                               uint8_t* __restrict__ out, int n) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * MOCHI_TREE_MXU_THREADS + threadIdx.x;
  const int sig = t / MOCHI_TREE_MXU_LANES;
  if ((t - lane) / MOCHI_TREE_MXU_LANES >= n) return;  // the whole warp is past the batch
  const int src = sig < n ? sig : n - 1;
  const tree17_warp_teams teams = {(lane >> 2) % MOCHI_TREE17_TEAMS};
  const int ok = comb_tree17_accumulate(teams, table, rows, __ldg(&key_idx[src]), bcomb,
                                        scratch + (size_t)src * MOCHI_TREE17_RECORD_INTS);
  if (sig < n && (lane & (MOCHI_TREE_MXU_LANES - 1)) == 0) out[sig] = (uint8_t)ok;
}

extern "C" {

// Both passes on `stream` (a cudaStream_t passed as a pointer); `scratch`
// holds n * MOCHI_TREE17_RECORD_INTS int32.  The arguments are
// comb_tree.cu's, with the table and the basepoint comb in 17 x 15-bit rows
// of 51 int32.  Returns the first launch error (cudaGetLastError) so the
// caller sees a refused launch.
int mochi_comb_tree_mxu_verify(const void* table, long long rows,
                               const void* key_idx, const void* y_r,
                               const void* sign_r, const void* s_bytes,
                               const void* h_bytes, const void* bcomb,
                               void* scratch, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  mochi_comb_tree_mxu_prepare_kernel<<<(n + MOCHI_TREE_MXU_PREP_SIGS - 1) / MOCHI_TREE_MXU_PREP_SIGS,
                                       MOCHI_TREE_MXU_THREADS, 0, st>>>(
      (const int32_t*)y_r, (const int32_t*)sign_r, (const uint8_t*)s_bytes,
      (const uint8_t*)h_bytes, (int32_t*)scratch, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mochi_comb_tree_mxu_kernel<<<(n + MOCHI_TREE_MXU_ACC_SIGS - 1) / MOCHI_TREE_MXU_ACC_SIGS,
                               MOCHI_TREE_MXU_THREADS, 0, st>>>(
      (const int32_t*)table, (int64_t)rows, (const int32_t*)key_idx,
      (const int32_t*)bcomb, (const int32_t*)scratch, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill + stack) bytes per thread, static
// shared bytes, threads per block, lanes a signature and dynamic shared
// bytes of a launch of the prepare pass (which = 0) or the accumulate pass
// (which = 1).
int mochi_comb_tree_mxu_verify_attrs(int which, int* regs, int* local_bytes,
                                     int* shared_bytes, int* threads, int* team,
                                     int* dynamic_shared_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err =
      which == 0 ? cudaFuncGetAttributes(&a, mochi_comb_tree_mxu_prepare_kernel)
                 : cudaFuncGetAttributes(&a, mochi_comb_tree_mxu_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = MOCHI_TREE_MXU_THREADS;
  *team = which == 0 ? 4 : MOCHI_TREE_MXU_LANES;
  *dynamic_shared_bytes = 0;
  return 0;
}

}  // extern "C"
