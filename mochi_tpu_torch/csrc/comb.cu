// Known-signer (comb) Ed25519 verification on Hopper: one signature per
// thread, no doublings.
//
// Replaces the reference package's comb.verify_comb_prepared, jitted as
// crypto/comb.py::_verify_comb_jit (impl="chain").  The arithmetic lives in
// comb25519.cuh on top of fe25519.cuh / ge25519.cuh, so the CPU tests
// compile the same code with g++.
//
// What bounds it: integer multiply throughput.  Per signature: 128 mixed
// additions of 7 multiplies (896), R's decode (ge_decode: 255 squarings and
// 19 multiplies, the pow22523 chain being 251 and 11) and 2 compare
// multiplies: 917 multiplies of 100 32x32->64 products and 255 squarings of
// 55, 105,725 multiply-adds (the general kernel, verify.cu: 274,070).
// Against 64 integer multiply-adds per clock per SM (compute capability
// 9.0) x 132 SMs x 1.98 GHz = 1.67e13 per second, 8192 signatures take at
// least 0.052 ms.  Bytes: 141 per signature in and out, plus one read of
// the signer table (69,120 bytes per signer, 4.4 MB at 64 signers) and the
// basepoint comb (69,120 bytes): microseconds at 3.35 TB/s, so the bound is
// operations.  Signer-row gathers are 64 x 120 bytes per signature from a
// table that stays in the 50 MB L2.
//
// Design.  The registry's tables are converted once per (device,
// generation) at upload to the kernel radix (comb25519.cuh's layout), so
// each window is two 120-byte row loads and two ge_madd.  The basepoint comb
// is 64 x 9 x 30 int32 = 69,120 bytes: over the 64 KB __constant__ bank,
// and divergent digits would serialise there anyway.  It is read with
// __ldg from global memory: in any one window a warp touches at most 9
// distinct 120-byte entries, which stay in L1, so a per-block shared-memory
// stage (61,440 bytes without the identity entries, which needs the >48 KB
// dynamic opt-in) would buy little and cost a copy per block.  Signer rows
// are gathered with __ldg too, the index clipped into the table.  One
// signature per thread keeps every chain independent; a launch hides the
// chain's latency only once each SM holds several warps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "comb25519.cuh"

#define MOCHI_COMB_THREADS 128

__global__ void __launch_bounds__(MOCHI_COMB_THREADS)
    mochi_comb_verify_kernel(const int32_t* __restrict__ table, int64_t rows,
                             const int32_t* __restrict__ key_idx,
                             const int32_t* __restrict__ y_r,
                             const int32_t* __restrict__ sign_r,
                             const uint8_t* __restrict__ s_bytes,
                             const uint8_t* __restrict__ h_bytes,
                             const int32_t* __restrict__ bcomb,
                             uint8_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // Inputs are batch-leading: the limbs of signature i are contiguous.
  int32_t yr[17];
  uint8_t s[32], h[32];
  for (int k = 0; k < 17; ++k) yr[k] = __ldg(&y_r[(size_t)i * 17 + k]);
  for (int k = 0; k < 32; ++k) {
    s[k] = __ldg(&s_bytes[(size_t)i * 32 + k]);
    h[k] = __ldg(&h_bytes[(size_t)i * 32 + k]);
  }
  out[i] = (uint8_t)comb_verify_one(table, rows, __ldg(&key_idx[i]), yr,
                                    __ldg(&sign_r[i]), s, h, bcomb);
}

extern "C" {

// Launch on `stream` (a cudaStream_t passed as a pointer); returns
// cudaGetLastError() so the caller sees a refused launch.
int mochi_comb_verify(const void* table, long long rows, const void* key_idx,
                      const void* y_r, const void* sign_r, const void* s_bytes,
                      const void* h_bytes, const void* bcomb, void* out, int n,
                      void* stream) {
  if (n > 0) {
    const int blocks = (n + MOCHI_COMB_THREADS - 1) / MOCHI_COMB_THREADS;
    mochi_comb_verify_kernel<<<blocks, MOCHI_COMB_THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const int32_t*)table, (int64_t)rows, (const int32_t*)key_idx,
        (const int32_t*)y_r, (const int32_t*)sign_r, (const uint8_t*)s_bytes,
        (const uint8_t*)h_bytes, (const int32_t*)bcomb, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill + stack) bytes per thread, static
// shared bytes and the threads per block the kernel launches with.
int mochi_comb_verify_attrs(int* regs, int* local_bytes, int* shared_bytes,
                            int* threads) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, mochi_comb_verify_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = MOCHI_COMB_THREADS;
  return 0;
}

}  // extern "C"
