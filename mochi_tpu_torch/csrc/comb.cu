// Known-signer (comb) Ed25519 verification on Hopper: one signature per
// team of four lanes, one in each warp of a block, no doublings.
//
// Replaces the reference package's comb.verify_comb_prepared, jitted as
// crypto/comb.py::_verify_comb_jit (impl="chain").  The arithmetic lives in
// comb25519.cuh on top of fe25519.cuh / ge25519.cuh and the team's verify
// in comb_team.cuh, so the CPU tests compile the same code with g++.
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
// What the design does about it (comb_team.cuh has the details).  The
// one-thread kernel this replaces ran a signature's 1,173 operations as one
// dependent chain (255 registers, 104 bytes of spills): any launch up to
// 8,192 lanes took ~0.7 ms, on as few SMs as its 128-thread blocks filled,
// one warp a scheduler.  Here a block is four warps for 32 signatures: lane
// l of warps 0-2 sums 19 windows of both tables for signature l (38 mixed
// additions), lane l of warp 3 decodes its R and then sums the top 7
// windows, and the warps add the four partial sums by a tree of two levels
// through the block's shared scratch (181 words a signature).  A role is a
// whole warp, so no warp diverges, and each warp carries about a quarter
// of the signature's multiplies.  The team runs the function's
// multiplies and 3 team additions of 9 more (108,425 multiply-adds a
// signature).
//
// What bounds the launch.  A small one runs at the decoding lane's time:
// R's 274 dependent operations, then its 7 windows.  A large one runs in
// waves of as many blocks as the SMs hold, which ptxas's registers decide.
// The field multiply and squaring are compiled once and called by value
// (MOCHI_FE_CALLED, fe25519.cuh): inlined at each of their call sites they
// made the kernel 7x larger and held it at 255 registers, and it ran
// slower at every launch size (PERF.md has these and the team sizes
// measured).  The tables are read as before: the basepoint comb (64 x 9 x
// 30 int32 = 69,120 bytes, over the 64 KB __constant__ bank) and the signer
// rows with __ldg from global memory through L1, the index clipped into
// the table.  Teams past the batch verify its last signature again and
// store nothing, so every barrier sees the whole block.
#include <cuda_runtime.h>
#include <stdint.h>

// One copy of the field multiply and squaring, called by value (fe25519.cuh).
#define MOCHI_FE_CALLED
#include "comb_team.cuh"

#define MOCHI_COMB_SIGS 32  // signatures a block: one a lane of each warp
#define MOCHI_COMB_THREADS (MOCHI_CT_TEAM * MOCHI_COMB_SIGS)

__global__ void __launch_bounds__(MOCHI_COMB_THREADS)
    mochi_comb_verify_kernel(const int32_t* __restrict__ table, int64_t rows,
                             const int32_t* __restrict__ key_idx,
                             const int32_t* __restrict__ y_r,
                             const int32_t* __restrict__ sign_r,
                             const uint8_t* __restrict__ s_bytes,
                             const uint8_t* __restrict__ h_bytes,
                             const int32_t* __restrict__ bcomb,
                             uint8_t* __restrict__ out, int n) {
  __shared__ ct_area area[MOCHI_COMB_SIGS];
  const int lane = threadIdx.x & 31;
  const int sig = blockIdx.x * MOCHI_COMB_SIGS + lane;
  // Inputs are batch-leading: the limbs of signature i are contiguous.
  const size_t i = sig < n ? sig : n - 1;
  ct_block_lanes ln;
  ln.r = threadIdx.x >> 5;
  const int ok = ct_verify(ln, &area[lane], table, rows, __ldg(&key_idx[i]), y_r + i * 17,
                           __ldg(&sign_r[i]), s_bytes + i * 32, h_bytes + i * 32, bcomb);
  if (sig < n && ln.r == 0) out[sig] = (uint8_t)ok;
}

extern "C" {

// Launch on `stream` (a cudaStream_t passed as a pointer); returns
// cudaGetLastError() so the caller sees a refused launch.
int mochi_comb_verify(const void* table, long long rows, const void* key_idx,
                      const void* y_r, const void* sign_r, const void* s_bytes,
                      const void* h_bytes, const void* bcomb, void* out, int n,
                      void* stream) {
  if (n > 0) {
    const int blocks = (n + MOCHI_COMB_SIGS - 1) / MOCHI_COMB_SIGS;
    mochi_comb_verify_kernel<<<blocks, MOCHI_COMB_THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const int32_t*)table, (int64_t)rows, (const int32_t*)key_idx,
        (const int32_t*)y_r, (const int32_t*)sign_r, (const uint8_t*)s_bytes,
        (const uint8_t*)h_bytes, (const int32_t*)bcomb, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill + stack) bytes per thread, static
// shared bytes, the threads per block the kernel launches with, the lanes a
// signature and the dynamic shared bytes of a launch (none: the scratch is
// static).
int mochi_comb_verify_attrs(int* regs, int* local_bytes, int* shared_bytes,
                            int* threads, int* team, int* dynamic_shared_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, mochi_comb_verify_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = MOCHI_COMB_THREADS;
  *team = MOCHI_CT_TEAM;
  *dynamic_shared_bytes = 0;
  return 0;
}

}  // extern "C"
