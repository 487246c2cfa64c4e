// Batched Ed25519 cofactorless verification on Hopper with every field
// multiply's column reduction on the integer tensor cores: a team of four
// lanes a signature, 8 signatures a warp.  Selected by MOCHI_SKEW_IMPL=mxu.
//
// Replaces the reference package's crypto/field.py:330 _mul_mxu (with its
// constant _build_mxu_matrix, :318) as it runs inside the general verify
// programs, batch_verify.py:274-275 _verify_jit / _verify_packed_jit
// (curve.verify_core with every rank-2 multiply and squaring on the MXU).
// The curve code is ge25519.cuh's, over the 17 x 15-bit field of fe17.cuh;
// the multiply is fe17_team.cuh's (this file defines MOCHI_FE17_TEAM),
// which says how a multiply becomes u8 x u8 -> s32 MMA products.
//
// What bounds it: the function is the general verify's, so its bound is
// verify.cu's (274,070 integer multiply-adds a signature over the IMAD
// rate: 0.134 ms at 8192 signatures on a 1980 MHz H100).  This layout pays
// more than that bound counts: 289 limb products and their byte splits a
// multiply against the 10-limb radix's 100, on a dependent chain of 3,433
// multiplies a signature, each a warp-wide tensor-core reduction.  The
// tensor-core work is small (57 m16n8k32 MMAs a call for 8 signatures,
// ~0.51 ms at 8192 signatures at the int8 peak).  A launch of up to ~4,000
// signatures runs at the latency of that chain, one warp a scheduler; a
// large one at the issue rate of the products, splits, shuffles and curve
// code, which every lane of a team repeats (PERF.md has both measured).
//
// What the design does about it.  fe17.cuh's warp-wide multiply (one
// signature a lane, 32 a warp, as the comb kernels run it) stages every
// lane's product words in shared memory, reloads them with ldmatrix, runs
// 196 MMAs and reads the accumulators back: ~1,550 instructions a lane and
// 13 warp barriers a multiply.  Here four lanes share a signature and each
// forms a quarter of its products straight into the A fragments
// (fe17_team.cuh): 57 MMAs, the columns land in the lanes that fold and
// carry them, 32 team shuffles, no shared memory and no barrier on the
// multiply's path.  The A rows g + 8 carry a second, independent multiply
// of the same signature: the additions and doublings hand their multiplies
// over in pairs (ge25519.cuh, fe_mul2), 2,125 calls a signature instead of
// 3,433, so two chains overlap in each; the decodes' chains stay one
// multiply a call.  A launch of n signatures runs n / 8 warps, so a small
// launch fills 4x the schedulers one signature a lane would.  Each team's
// [0..8](-A) table (2,448 bytes) lives in the block's dynamic shared
// memory, written by the four lanes alike, instead of four copies in local
// memory.  Every lane of a warp must reach every multiply (mma.sync and the
// shuffles are warp-wide), so teams past the batch verify its last
// signature and only their store is masked, a warp with no signature in the
// batch leaves before any multiply, and no branch around a multiply depends
// on a lane's data (ge25519.cuh's branchless forms for this field).  wgmma
// (64 rows a warpgroup: 16 signatures a warp) is later work.
#define MOCHI_FE17_TEAM
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe17.cuh"
#include "fe17_team.cuh"
#include "ge25519.cuh"

#define MOCHI_MXU_TEAM_THREADS 64                            // 2 warps a block
#define MOCHI_MXU_TEAM_SIGS (MOCHI_MXU_TEAM_THREADS / 4)  // signatures a block
// Dynamic shared bytes of a launch: the teams' [0..8](-A) tables.
#define MOCHI_MXU_PTAB_BYTES (MOCHI_MXU_TEAM_SIGS * 9 * (int)sizeof(ge_cached_t<fe17>))

__global__ void __launch_bounds__(MOCHI_MXU_TEAM_THREADS)
    mochi_ed25519_verify_mxu_kernel(const int32_t* __restrict__ y_a,
                                    const int32_t* __restrict__ sign_a,
                                    const int32_t* __restrict__ y_r,
                                    const int32_t* __restrict__ sign_r,
                                    const uint8_t* __restrict__ s_bytes,
                                    const uint8_t* __restrict__ h_bytes,
                                    const int32_t* __restrict__ b_tab,
                                    uint8_t* __restrict__ out, int n) {
  // [0..8]B in Niels form, 17 x 15-bit limbs: (9, 3, 17) int32
  __shared__ ge_niels_t<fe17> btab[9];
  extern __shared__ ge_cached_t<fe17> ptabs[];  // 9 entries a team
  int32_t* flat = reinterpret_cast<int32_t*>(btab);
  for (int i = threadIdx.x; i < 9 * 3 * 17; i += blockDim.x) flat[i] = __ldg(&b_tab[i]);
  __syncthreads();
  const int team = threadIdx.x >> 2;
  const int i = blockIdx.x * MOCHI_MXU_TEAM_SIGS + team;  // this team's signature
  if (i - (int)((threadIdx.x & 31) >> 2) >= n) return;  // the whole warp is past the batch
  const int src = i < n ? i : n - 1;
  int32_t ya[17], yr[17];
  uint8_t s[32], h[32];
  for (int k = 0; k < 17; ++k) {
    ya[k] = __ldg(&y_a[(size_t)src * 17 + k]);
    yr[k] = __ldg(&y_r[(size_t)src * 17 + k]);
  }
  for (int k = 0; k < 32; ++k) {
    s[k] = __ldg(&s_bytes[(size_t)src * 32 + k]);
    h[k] = __ldg(&h_bytes[(size_t)src * 32 + k]);
  }
  const int ok = ed25519_verify_one(ya, __ldg(&sign_a[src]), yr, __ldg(&sign_r[src]), s, h, 1,
                                    static_cast<const ge_niels_t<fe17>*>(btab), ptabs + 9 * team);
  if (i < n && (threadIdx.x & 3) == 0) out[i] = (uint8_t)ok;
}

// n independent multiplies, limbs leading: a, b, out are (17, n) int32; a
// team of four lanes a pair, lane t storing limbs t, t + 4, ...
__global__ void __launch_bounds__(MOCHI_MXU_TEAM_THREADS)
    mochi_fe17_mul_mxu_kernel(const int32_t* __restrict__ a,
                              const int32_t* __restrict__ b,
                              int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * MOCHI_MXU_TEAM_SIGS + (threadIdx.x >> 2);
  if (i - (int)((threadIdx.x & 31) >> 2) >= n) return;
  const int src = i < n ? i : n - 1;
  fe17 x, y, z;
  for (int k = 0; k < 17; ++k) {
    x.v[k] = __ldg(&a[(size_t)k * n + src]);
    y.v[k] = __ldg(&b[(size_t)k * n + src]);
  }
  fe_mul(&z, &x, &y);
  if (i < n)
    for (int k = 0; k < 17; ++k)
      if ((k & 3) == (int)(threadIdx.x & 3)) out[(size_t)k * n + i] = z.v[k];
}

extern "C" {

// Launch on `stream` (a cudaStream_t passed as a pointer); returns
// cudaGetLastError() so the caller sees a refused launch.  The arguments
// are verify.cu's, with the (9, 3, 17) table of fe17 limbs.
int mochi_ed25519_verify_mxu(const void* y_a, const void* sign_a, const void* y_r,
                             const void* sign_r, const void* s_bytes,
                             const void* h_bytes, const void* b_tab, void* out,
                             int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + MOCHI_MXU_TEAM_SIGS - 1) / MOCHI_MXU_TEAM_SIGS;
    mochi_ed25519_verify_mxu_kernel<<<blocks, MOCHI_MXU_TEAM_THREADS, MOCHI_MXU_PTAB_BYTES,
                                      (cudaStream_t)stream>>>(
        (const int32_t*)y_a, (const int32_t*)sign_a, (const int32_t*)y_r,
        (const int32_t*)sign_r, (const uint8_t*)s_bytes, (const uint8_t*)h_bytes,
        (const int32_t*)b_tab, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int mochi_fe17_mul_mxu(const void* a, const void* b, void* out, int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + MOCHI_MXU_TEAM_SIGS - 1) / MOCHI_MXU_TEAM_SIGS;
    mochi_fe17_mul_mxu_kernel<<<blocks, MOCHI_MXU_TEAM_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill + stack) bytes per thread, static
// shared bytes, threads per block, lanes a signature and dynamic shared
// bytes of a launch, of the verify kernel (which = 0) or the batch multiply
// (which = 1).
int mochi_ed25519_verify_mxu_attrs(int which, int* regs, int* local_bytes, int* shared_bytes,
                                   int* threads, int* team, int* dynamic_shared_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err =
      which == 0 ? cudaFuncGetAttributes(&a, mochi_ed25519_verify_mxu_kernel)
                 : cudaFuncGetAttributes(&a, mochi_fe17_mul_mxu_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = MOCHI_MXU_TEAM_THREADS;
  *team = 4;
  *dynamic_shared_bytes = which == 0 ? MOCHI_MXU_PTAB_BYTES : 0;
  return 0;
}

}  // extern "C"
