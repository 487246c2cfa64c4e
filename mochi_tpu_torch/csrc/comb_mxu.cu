// Known-signer (comb) Ed25519 verification on Hopper with every field
// multiply's column reduction on the integer tensor cores: one signature per
// lane, 32 signatures a warp.  The comb chain under MOCHI_SKEW_IMPL=mxu.
//
// Replaces the reference package's crypto/comb.py:512 _verify_comb_jit with
// impl="chain" (:477-509) as it runs under MOCHI_SKEW_IMPL=mxu, where every
// rank-2 multiply and squaring is crypto/field.py:330 _mul_mxu.  The
// arithmetic lives in comb17.cuh (the chain) on ge25519.cuh's curve code
// over fe17.cuh's field, whose header says how a multiply becomes one
// u8 x u8 -> s32 MMA product; the CPU tests compile the same code with g++.
//
// What bounds it: the function is the comb chain's, so its bound is
// comb.cu's (105,725 integer multiply-adds a signature over the IMAD rate:
// 0.052 ms at 8192 signatures on a 1980 MHz H100).  This kernel pays far
// more per multiply than that bound counts: 1,173 dependent multiplies and
// squarings a signature (128 mixed additions of 7, R's decode, the compare),
// each a warp-wide tensor-core reduction of 196 m16n8k32 MMAs, 25,088
// multiply-adds a signature (~0.24 ms at 8192 signatures at the int8 peak),
// staged through shared memory with 13 warp barriers, at most 8 warps an SM
// (255 registers a thread).  Bytes: 141 a signature in and out, the signer
// rows (204 bytes each, 64 a signature, from a table that stays in the
// 50 MB L2) and the basepoint comb (117,504 bytes): microseconds.  So the
// time goes to the latency of that chain of multiplies.
//
// Design.  The registry's rows are uploaded as they are (no radix
// conversion); a window is two 204-byte row loads, ge_niels_signed's
// branchless negation and two ge_madd.  The basepoint comb is read with
// __ldg from global memory, as comb.cu reads its own.  Every lane of a warp
// must reach every multiply (mma.sync is warp-wide), so lanes past the batch
// compute on the last lane's input and only their store is masked, and a
// warp with no lane in the batch leaves before any multiply.  Blocks are
// 32 * MOCHI_MXU_WARPS threads: fe17_mul_warp indexes its shared staging by
// the warp's number in the block.  wgmma, more warps an SM and keeping the
// constant A fragments in registers are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "comb17.cuh"

#define MOCHI_COMB_MXU_THREADS (32 * MOCHI_MXU_WARPS)

__global__ void __launch_bounds__(MOCHI_COMB_MXU_THREADS)
    mochi_comb_mxu_verify_kernel(const int32_t* __restrict__ table, int64_t rows,
                                 const int32_t* __restrict__ key_idx,
                                 const int32_t* __restrict__ y_r,
                                 const int32_t* __restrict__ sign_r,
                                 const uint8_t* __restrict__ s_bytes,
                                 const uint8_t* __restrict__ h_bytes,
                                 const int32_t* __restrict__ bcomb,
                                 uint8_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i - (int)(threadIdx.x & 31) >= n) return;  // the whole warp is past the batch
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
  if (i < n) out[i] = (uint8_t)ok;
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
    const int blocks = (n + MOCHI_COMB_MXU_THREADS - 1) / MOCHI_COMB_MXU_THREADS;
    mochi_comb_mxu_verify_kernel<<<blocks, MOCHI_COMB_MXU_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        (const int32_t*)table, (int64_t)rows, (const int32_t*)key_idx,
        (const int32_t*)y_r, (const int32_t*)sign_r, (const uint8_t*)s_bytes,
        (const uint8_t*)h_bytes, (const int32_t*)bcomb, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill + stack) bytes per thread, static
// shared bytes and the threads per block the kernel launches with.
int mochi_comb_mxu_verify_attrs(int* regs, int* local_bytes, int* shared_bytes,
                                int* threads) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, mochi_comb_mxu_verify_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = MOCHI_COMB_MXU_THREADS;
  return 0;
}

}  // extern "C"
