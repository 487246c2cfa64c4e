// Batched Ed25519 cofactorless verification on Hopper: one signature per
// thread.
//
// Replaces the reference package's one Pallas kernel,
// crypto/pallas_verify.py::_kernel (the body is curve.verify_core, which is
// also what the reference's default XLA program runs).  The arithmetic lives
// in fe25519.cuh / ge25519.cuh so the CPU tests compile the same code.
//
// What bounds it: integer multiply throughput.  Per signature the kernel
// does 2,883 field multiplies and squarings in the ladder (64 windows x
// (16 squarings + 13 multiplies for the four doublings + 8 for the table
// addition + 7 for the mixed addition) = 2,816, plus 65 for the [0..8](-A)
// table and 2 for the compare) and two decodes of 274 each (the pow22523
// chain is 251 squarings and 11 multiplies): 1,534 squarings and 1,897
// multiplies in all.  In radix 2^25.5 a multiply is 100 32x32->64 products
// and a squaring 55: 274,070 multiply-add instructions per signature,
// against the throughput table's 64 32-bit integer multiply(-add) results
// per clock per SM for compute capability 9.0, x 132 SMs x the SM clock
// (nvidia-smi clocks.max.sm; 1980 MHz on an H100 SXM gives 1.67e13 per
// second, so 8192 signatures take at least 0.134 ms).  The bytes moved
// (208 per signature in, 1 out) are negligible.
//
// What the design does about it: the radix is chosen so every limb product
// is a single widening multiply-add into a 64-bit accumulator with no
// carries between products; squarings use the symmetric 55-product form;
// doublings skip T except before an addition; the [0..8](-A) table is kept
// in cached form (Y+X, Y-X, Z, 2dT) so each table addition is 8 multiplies.
// The per-thread table (9 points, 1,440 bytes) lives in local memory in
// this first kernel; the constant [0..8]B Niels table (1,080 bytes) is
// copied into shared memory per block, since divergent indexes into
// __constant__ memory serialise.  One signature per thread keeps each
// chain independent; its cost is latency: a launch hides it only once
// every SM holds more than one block, so small launches run at the speed
// of one thread's dependent chain (PERF.md has the launch-size sweep).
#include <cuda_runtime.h>
#include <stdint.h>

#include "ge25519.cuh"

#define MOCHI_VERIFY_THREADS 128

__global__ void __launch_bounds__(MOCHI_VERIFY_THREADS)
    mochi_ed25519_verify_kernel(const int32_t* __restrict__ y_a,
                                const int32_t* __restrict__ sign_a,
                                const int32_t* __restrict__ y_r,
                                const int32_t* __restrict__ sign_r,
                                const uint8_t* __restrict__ s_bytes,
                                const uint8_t* __restrict__ h_bytes,
                                const int32_t* __restrict__ b_tab,
                                uint8_t* __restrict__ out, int n) {
  __shared__ ge_niels btab[9];
  int32_t* flat = reinterpret_cast<int32_t*>(btab);
  for (int i = threadIdx.x; i < 9 * 30; i += blockDim.x) flat[i] = __ldg(&b_tab[i]);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // Inputs are batch-leading: limbs of signature i are contiguous (stride 1).
  int32_t ya[17], yr[17];
  uint8_t s[32], h[32];
  for (int k = 0; k < 17; ++k) {
    ya[k] = __ldg(&y_a[(size_t)i * 17 + k]);
    yr[k] = __ldg(&y_r[(size_t)i * 17 + k]);
  }
  for (int k = 0; k < 32; ++k) {
    s[k] = __ldg(&s_bytes[(size_t)i * 32 + k]);
    h[k] = __ldg(&h_bytes[(size_t)i * 32 + k]);
  }
  out[i] = (uint8_t)ed25519_verify_one(ya, __ldg(&sign_a[i]), yr,
                                       __ldg(&sign_r[i]), s, h, 1, btab);
}

extern "C" {

// Launch on `stream` (a cudaStream_t passed as a pointer); returns
// cudaGetLastError() so the caller sees a refused launch.
int mochi_ed25519_verify(const void* y_a, const void* sign_a, const void* y_r,
                         const void* sign_r, const void* s_bytes,
                         const void* h_bytes, const void* b_tab, void* out,
                         int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + MOCHI_VERIFY_THREADS - 1) / MOCHI_VERIFY_THREADS;
    mochi_ed25519_verify_kernel<<<blocks, MOCHI_VERIFY_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        (const int32_t*)y_a, (const int32_t*)sign_a, (const int32_t*)y_r,
        (const int32_t*)sign_r, (const uint8_t*)s_bytes,
        (const uint8_t*)h_bytes, (const int32_t*)b_tab, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill + stack) bytes per thread, static
// shared bytes and the threads per block the kernel launches with.
int mochi_ed25519_verify_attrs(int* regs, int* local_bytes, int* shared_bytes,
                               int* threads) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, mochi_ed25519_verify_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = MOCHI_VERIFY_THREADS;
  return 0;
}

}  // extern "C"
