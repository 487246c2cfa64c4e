// Batched Ed25519 cofactorless verification on Hopper with every field
// multiply's column reduction on the integer tensor cores: one signature per
// lane, 32 signatures a warp.  Selected by MOCHI_SKEW_IMPL=mxu.
//
// Replaces the reference package's crypto/field.py:330 _mul_mxu (with its
// constant _build_mxu_matrix, :318) as it runs inside the general verify
// programs, batch_verify.py:274-275 _verify_jit / _verify_packed_jit
// (curve.verify_core with every rank-2 multiply and squaring on the MXU).
// The curve code is ge25519.cuh's, over the 17 x 15-bit field of fe17.cuh;
// fe17.cuh says how a multiply becomes one u8 x u8 -> s32 MMA product.
//
// What bounds it: the function is the general verify's, so its bound is
// verify.cu's (274,070 integer multiply-adds a signature over the IMAD
// rate: 0.134 ms at 8192 signatures on a 1980 MHz H100).  This kernel
// pays far more per multiply than that bound counts: per warp and multiply
// 289 IMADs a lane for the products, 86 16-byte shared stores and 86
// ldmatrix loads, 196 mma.sync, 40 accumulator stores and 68 loads back,
// and 13 warp barriers, on a dependent chain of ~3,430 multiplies a
// signature.  Its tensor-core work is small (196 m16n8k32 MMAs, 25,088
// multiply-adds a signature-multiply, ~0.7 ms at 8192 signatures at the
// int8 peak); its time goes to shared-memory round trips and the latency
// of that chain, with at most 8 warps an SM (255 registers a thread).
//
// What the design does about it: products are streamed to shared memory 8
// k-steps at a time instead of being held in registers; the all-zero tiles
// of the 0/1 matrix are skipped at compile time (196 of 860 MMAs run); the
// A fragments come from an 11-entry table a lane builds once per multiply;
// staging rows are padded so ldmatrix and the stores are free of bank
// conflicts.  Every lane of a warp must reach every multiply (mma.sync is
// warp-wide), so lanes past the batch compute on the last lane's input and
// only their store is masked, a warp with no lane in the batch leaves
// before any multiply, and no branch around a multiply depends on a lane's
// data (ge25519.cuh's branchless forms for this field).  wgmma, keeping the
// constant in registers across multiplies and more signatures per warp are
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe17.cuh"
#include "ge25519.cuh"

#define MOCHI_MXU_THREADS (32 * MOCHI_MXU_WARPS)

__global__ void __launch_bounds__(MOCHI_MXU_THREADS)
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
  int32_t* flat = reinterpret_cast<int32_t*>(btab);
  for (int i = threadIdx.x; i < 9 * 3 * 17; i += blockDim.x) flat[i] = __ldg(&b_tab[i]);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i - (int)(threadIdx.x & 31) >= n) return;  // the whole warp is past the batch
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
                                    static_cast<const ge_niels_t<fe17>*>(btab));
  if (i < n) out[i] = (uint8_t)ok;
}

// n independent multiplies, limbs leading: a, b, out are (17, n) int32.
__global__ void __launch_bounds__(MOCHI_MXU_THREADS)
    mochi_fe17_mul_mxu_kernel(const int32_t* __restrict__ a,
                              const int32_t* __restrict__ b,
                              int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i - (int)(threadIdx.x & 31) >= n) return;
  const int src = i < n ? i : n - 1;
  fe17 x, y, z;
  for (int k = 0; k < 17; ++k) {
    x.v[k] = __ldg(&a[(size_t)k * n + src]);
    y.v[k] = __ldg(&b[(size_t)k * n + src]);
  }
  fe_mul(&z, &x, &y);
  if (i < n)
    for (int k = 0; k < 17; ++k) out[(size_t)k * n + i] = z.v[k];
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
    const int blocks = (n + MOCHI_MXU_THREADS - 1) / MOCHI_MXU_THREADS;
    mochi_ed25519_verify_mxu_kernel<<<blocks, MOCHI_MXU_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)y_a, (const int32_t*)sign_a, (const int32_t*)y_r,
        (const int32_t*)sign_r, (const uint8_t*)s_bytes, (const uint8_t*)h_bytes,
        (const int32_t*)b_tab, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int mochi_fe17_mul_mxu(const void* a, const void* b, void* out, int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + MOCHI_MXU_THREADS - 1) / MOCHI_MXU_THREADS;
    mochi_fe17_mul_mxu_kernel<<<blocks, MOCHI_MXU_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill + stack) bytes per thread, static
// shared bytes and the threads per block of the verify kernel (which = 0)
// or the batch multiply (which = 1).
int mochi_ed25519_verify_mxu_attrs(int which, int* regs, int* local_bytes,
                                   int* shared_bytes, int* threads) {
  cudaFuncAttributes a;
  const cudaError_t err =
      which == 0 ? cudaFuncGetAttributes(&a, mochi_ed25519_verify_mxu_kernel)
                 : cudaFuncGetAttributes(&a, mochi_fe17_mul_mxu_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = MOCHI_MXU_THREADS;
  return 0;
}

}  // extern "C"
