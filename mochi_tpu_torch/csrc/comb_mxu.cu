// Known-signer (comb) Ed25519 verification on Hopper with every field
// multiply's column reduction on the integer tensor cores: a team of four
// lanes a signature, 8 signatures a warp.  The comb chain under
// MOCHI_SKEW_IMPL=mxu.
//
// Replaces the reference package's crypto/comb.py:512 _verify_comb_jit with
// impl="chain" (:477-509) as it runs under MOCHI_SKEW_IMPL=mxu, where every
// rank-2 multiply and squaring is crypto/field.py:330 _mul_mxu.  The
// arithmetic lives in comb17.cuh (the chain) on ge25519.cuh's curve code
// over fe17.cuh's field; the multiply is fe17_team.cuh's (this file defines
// MOCHI_FE17_TEAM), which says how a multiply becomes u8 x u8 -> s32 MMA
// products.  The CPU tests compile the same code with g++.
//
// What bounds it: the function is the comb chain's, so its bound is
// comb.cu's (105,725 integer multiply-adds a signature over the IMAD rate:
// 0.052 ms at 8192 signatures on a 1980 MHz H100).  Bytes: 141 a signature
// in and out, the signer rows (204 bytes each, 64 a signature, from a table
// that stays in the 50 MB L2) and the basepoint comb (117,504 bytes):
// microseconds.  This layout pays more than the bound counts: a dependent
// chain of 1,173 multiplies and squarings a signature (128 mixed additions
// of 7, R's decode of 275, the compare's 2), each of 289 limb products and
// their byte splits, each a warp-wide tensor-core reduction.  So a launch
// runs at the latency of that chain, and a large one at the issue rate of
// the products, splits, shuffles and curve code, which every lane of a team
// repeats (PERF.md has both measured).
//
// What the design does about it.  fe17.cuh's warp-wide multiply (one signature
// a lane, 32 a warp) stages every lane's
// product words in shared memory, reloads them with ldmatrix, runs 196 MMAs
// and reads the accumulators back: ~1,550 instructions a lane and 13 warp
// barriers a multiply.  Here four lanes share a signature and each forms a
// quarter of its products straight into the A fragments (fe17_team.cuh): 57
// MMAs a call, no shared memory and no barrier on the multiply's path.  The A
// rows g + 8 carry a second, independent multiply of the same signature:
// ge_madd hands its multiplies over in pairs and the compare its two
// (comb17.cuh, ge25519.cuh), 788 calls a signature instead of 1,173
// multiplies; R's decode stays one multiply a call.  A launch of n signatures
// runs n / 8 warps, so a small launch fills 4x the schedulers one signature a
// lane would.  The chain needs no per-signature table: the signer's rows and
// the basepoint comb are read with __ldg, the four lanes of a team loading
// the same addresses (one request).  Every lane of a warp must reach every
// multiply (mma.sync and the shuffles are warp-wide), so teams past the batch
// verify its last signature and only their store is masked, a warp with no
// signature in the batch leaves before any multiply, and nothing branches on
// a lane's data around a multiply (comb_row's clip and ge_niels_signed's
// negation are selects).  Interleaving part of R's decode into the 128 lone
// multiplies of the mixed additions (rows g + 8 are free there) and wgmma are
// later work.
#define MOCHI_FE17_TEAM
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe17.cuh"
#include "fe17_team.cuh"
#include "comb17.cuh"

#define MOCHI_MXU_TEAM_THREADS 64                            // 2 warps a block
#define MOCHI_MXU_TEAM_SIGS (MOCHI_MXU_TEAM_THREADS / 4)  // signatures a block

__global__ void __launch_bounds__(MOCHI_MXU_TEAM_THREADS)
    mochi_comb_mxu_verify_kernel(const int32_t* __restrict__ table, int64_t rows,
                                 const int32_t* __restrict__ key_idx,
                                 const int32_t* __restrict__ y_r,
                                 const int32_t* __restrict__ sign_r,
                                 const uint8_t* __restrict__ s_bytes,
                                 const uint8_t* __restrict__ h_bytes,
                                 const int32_t* __restrict__ bcomb,
                                 uint8_t* __restrict__ out, int n) {
  const int team = threadIdx.x >> 2;
  const int i = blockIdx.x * MOCHI_MXU_TEAM_SIGS + team;  // this team's signature
  if (i - (int)((threadIdx.x & 31) >> 2) >= n) return;  // the whole warp is past the batch
  const int src = i < n ? i : n - 1;
  int32_t yr[17];
  uint8_t s[32], h[32];
  for (int k = 0; k < 17; ++k) yr[k] = __ldg(&y_r[(size_t)src * 17 + k]);
  for (int k = 0; k < 32; ++k) {
    s[k] = __ldg(&s_bytes[(size_t)src * 32 + k]);
    h[k] = __ldg(&h_bytes[(size_t)src * 32 + k]);
  }
  const int ok = comb17_verify_one(table, rows, __ldg(&key_idx[src]), yr,
                                   __ldg(&sign_r[src]), s, h, bcomb);
  if (i < n && (threadIdx.x & 3) == 0) out[i] = (uint8_t)ok;
}

extern "C" {

// Launch on `stream` (a cudaStream_t passed as a pointer); returns
// cudaGetLastError() so the caller sees a refused launch.  The arguments
// are comb.cu's, with the table and the basepoint comb in 17 x 15-bit rows
// of 51 int32.
int mochi_comb_mxu_verify(const void* table, long long rows, const void* key_idx,
                          const void* y_r, const void* sign_r, const void* s_bytes,
                          const void* h_bytes, const void* bcomb, void* out, int n,
                          void* stream) {
  if (n > 0) {
    const int blocks = (n + MOCHI_MXU_TEAM_SIGS - 1) / MOCHI_MXU_TEAM_SIGS;
    mochi_comb_mxu_verify_kernel<<<blocks, MOCHI_MXU_TEAM_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        (const int32_t*)table, (int64_t)rows, (const int32_t*)key_idx,
        (const int32_t*)y_r, (const int32_t*)sign_r, (const uint8_t*)s_bytes,
        (const uint8_t*)h_bytes, (const int32_t*)bcomb, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill + stack) bytes per thread, static
// shared bytes, threads per block, lanes a signature and dynamic shared
// bytes of a launch.
int mochi_comb_mxu_verify_attrs(int* regs, int* local_bytes, int* shared_bytes,
                                int* threads, int* team, int* dynamic_shared_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, mochi_comb_mxu_verify_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = MOCHI_MXU_TEAM_THREADS;
  *team = 4;
  *dynamic_shared_bytes = 0;
  return 0;
}

}  // extern "C"
