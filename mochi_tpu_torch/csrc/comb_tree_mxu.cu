// Known-signer (comb) Ed25519 verification on Hopper with the tree
// accumulation and every field multiply's column reduction on the integer
// tensor cores: one warp per signature.  The comb tree under
// MOCHI_SKEW_IMPL=mxu.
//
// Replaces the reference package's comb.verify_comb_prepared with
// impl="tree" (crypto/comb.py:428-472, _tree_accumulate :354) as it runs
// under MOCHI_SKEW_IMPL=mxu, where every rank-2 multiply of the leaf
// conversion, of each level's complete addition and of the compare is
// crypto/field.py:330 _mul_mxu.  The arithmetic lives in comb_tree17.cuh
// (the tree over comb17.cuh's row loads and ge25519.cuh's formulas over
// fe17.cuh's field, whose header says how a multiply becomes one
// u8 x u8 -> s32 MMA product); the CPU tests compile the same code with
// g++.  Where the reference selects the basepoint rows with a one-hot
// float32 matmul, this kernel loads the row its digit names.
//
// Design.  comb_tree.cu's two launches on the caller's stream, in the 17 x
// 15-bit field.  The prepare pass, one signature per lane, decodes R (275
// dependent multiplies) and recodes both scalars into a record of
// MOCHI_TREE17_RECORD_INTS int32 (268 bytes).  The accumulate pass, one
// warp per signature, sums the 128 window points as comb_tree.cu does:
// lane l holds windows l and l + 32 (leaf + mixed addition each, then their
// sum), then 5 levels take the partner's point by __shfl_down_sync at
// offsets 16 ... 1 (4 x 17 int32 a point), and the sum lands on lane 0.
// Every lane calls fe17_mul_warp on its own operands, so the warp-wide
// multiply serves 32 tree nodes of one signature as it serves 32
// signatures in comb_mxu.cu; a lane's dependent chain is 76 multiplies
// (74 for its windows and the levels, 2 for the compare) instead of the
// chain's 1,173.
//
// Convergence.  mma.sync is warp-wide and a diverged warp traps in the
// multiply: the accumulate pass leaves only as a whole warp (sig >= n),
// every lane computes the compare and only lane 0 stores; in the prepare
// pass lanes past the batch recompute the last signature, a warp with no
// lane in the batch leaves before any multiply, and the store is masked.
// Both passes launch 32 * MOCHI_MXU_WARPS threads a block: fe17_mul_warp
// indexes its shared staging by the warp's number in the block.
//
// What bounds it: the function is the comb's, so its bound is comb.cu's
// (105,725 integer multiply-adds a signature over the IMAD rate: 0.052 ms
// at 8192 signatures on a 1980 MHz H100).  This kernel issues far more:
// 275 multiplies a signature in the prepare pass and 76 warp-wide ones in
// the accumulate pass, each a tensor-core reduction of 196 m16n8k32 MMAs
// (2,707 lane-multiplies of 25,088 multiply-adds a signature, ~0.56 ms at
// 8192 signatures at the int8 peak), on dependent chains of 275 and 76
// multiplies of ~4 us each.  Bytes: 141 a signature in and out, the record
// written and read once, 128 row gathers of 204 bytes from tables that stay
// in the 50 MB L2: microseconds.  So the time goes to the latency of those
// chains.  wgmma, more warps an SM and sharing the prepare pass's
// constants are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "comb_tree17.cuh"

#define MOCHI_TREE_MXU_THREADS (32 * MOCHI_MXU_WARPS)

__global__ void __launch_bounds__(MOCHI_TREE_MXU_THREADS)
    mochi_comb_tree_mxu_prepare_kernel(const int32_t* __restrict__ y_r,
                                       const int32_t* __restrict__ sign_r,
                                       const uint8_t* __restrict__ s_bytes,
                                       const uint8_t* __restrict__ h_bytes,
                                       int32_t* __restrict__ scratch, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i - (int)(threadIdx.x & 31) >= n) return;  // the whole warp is past the batch
  const int src = i < n ? i : n - 1;
  int32_t yr[17], rec[MOCHI_TREE17_RECORD_INTS];
  uint8_t s[32], h[32];
  for (int k = 0; k < 17; ++k) yr[k] = __ldg(&y_r[(size_t)src * 17 + k]);
  for (int k = 0; k < 32; ++k) {
    s[k] = __ldg(&s_bytes[(size_t)src * 32 + k]);
    h[k] = __ldg(&h_bytes[(size_t)src * 32 + k]);
  }
  comb_tree17_prepare(rec, yr, __ldg(&sign_r[src]), s, h);
  if (i < n)
    for (int k = 0; k < MOCHI_TREE17_RECORD_INTS; ++k)
      scratch[(size_t)i * MOCHI_TREE17_RECORD_INTS + k] = rec[k];
}

__device__ __forceinline__ void shfl_down_fe17(fe17* r, const fe17* f, int off) {
#pragma unroll
  for (int k = 0; k < 17; ++k) r->v[k] = __shfl_down_sync(0xffffffffu, f->v[k], off);
}

__global__ void __launch_bounds__(MOCHI_TREE_MXU_THREADS)
    mochi_comb_tree_mxu_kernel(const int32_t* __restrict__ table, int64_t rows,
                               const int32_t* __restrict__ key_idx,
                               const int32_t* __restrict__ bcomb,
                               const int32_t* __restrict__ scratch,
                               uint8_t* __restrict__ out, int n) {
  const int sig = blockIdx.x * MOCHI_MXU_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (sig >= n) return;  // the whole warp: no multiply or shuffle is left half-joined
  const int32_t* rec = scratch + (size_t)sig * MOCHI_TREE17_RECORD_INTS;
  const int8_t* dig = (const int8_t*)(rec + MOCHI_TREE17_RECORD_DIGITS);
  const int key = __ldg(&key_idx[sig]);
  ge_p3_t<fe17> acc, other;
  comb_tree17_window(&acc, table, rows, key, bcomb, lane, dig[64 + lane], dig[lane]);
  comb_tree17_window(&other, table, rows, key, bcomb, lane + 32, dig[96 + lane], dig[32 + lane]);
  comb_tree17_add(&acc, &acc, &other);
#pragma unroll 1
  for (int off = 16; off >= 1; off >>= 1) {
    shfl_down_fe17(&other.X, &acc.X, off);
    shfl_down_fe17(&other.Y, &acc.Y, off);
    shfl_down_fe17(&other.Z, &acc.Z, off);
    shfl_down_fe17(&other.T, &acc.T, off);
    comb_tree17_add(&acc, &acc, &other);
  }
  // every lane multiplies (the warp-wide multiply); lane 0 holds the sum
  const int ok = comb_tree17_finish(&acc, rec);
  if (lane == 0) out[sig] = (uint8_t)ok;
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
  mochi_comb_tree_mxu_prepare_kernel<<<(n + MOCHI_TREE_MXU_THREADS - 1) /
                                           MOCHI_TREE_MXU_THREADS,
                                       MOCHI_TREE_MXU_THREADS, 0, st>>>(
      (const int32_t*)y_r, (const int32_t*)sign_r, (const uint8_t*)s_bytes,
      (const uint8_t*)h_bytes, (int32_t*)scratch, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mochi_comb_tree_mxu_kernel<<<(n + MOCHI_MXU_WARPS - 1) / MOCHI_MXU_WARPS,
                               MOCHI_TREE_MXU_THREADS, 0, st>>>(
      (const int32_t*)table, (int64_t)rows, (const int32_t*)key_idx,
      (const int32_t*)bcomb, (const int32_t*)scratch, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill + stack) bytes per thread, static
// shared bytes and threads per block of the prepare pass (which = 0) or
// the accumulate pass (which = 1).
int mochi_comb_tree_mxu_verify_attrs(int which, int* regs, int* local_bytes,
                                     int* shared_bytes, int* threads) {
  cudaFuncAttributes a;
  const cudaError_t err =
      which == 0 ? cudaFuncGetAttributes(&a, mochi_comb_tree_mxu_prepare_kernel)
                 : cudaFuncGetAttributes(&a, mochi_comb_tree_mxu_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = MOCHI_TREE_MXU_THREADS;
  return 0;
}

}  // extern "C"
