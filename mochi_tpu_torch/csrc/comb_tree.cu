// Known-signer (comb) Ed25519 verification on Hopper with the tree
// accumulation: one warp per signature.
//
// Replaces the reference package's comb.verify_comb_prepared with
// impl="tree" (crypto/comb.py:428-472, _tree_accumulate :354), selected by
// MOCHI_COMB_IMPL=tree.  The arithmetic lives in comb_tree.cuh on top of
// comb25519.cuh, so the CPU tests compile the same code with g++.  Where the
// reference selects the basepoint rows with a one-hot float32 matmul, this
// kernel loads the row its digit names: integer arithmetic only.
//
// Design.  The chain (comb.cu) is 128 dependent mixed additions per
// thread.  The tree cuts that dependent depth to 7 levels by spreading one
// signature's 128 window points over the 32 lanes of a warp: lane l holds
// windows l and l + 32, of the signer and of the basepoint.  Levels 1 and 2
// of the reference's pairing (point i with i + P/2) are then local to the
// lane: S_l + B_l, S_{l+32} + B_{l+32}, and their sum.  Levels 3-7 take the
// partner's point by __shfl_down_sync at offsets 16, 8, 4, 2, 1 (40 int32 a
// point) and the sum lands on lane 0, which does the compare.  Every lane
// runs every level (SIMT issues a warp's instruction once for all lanes),
// so the lanes past each level's half compute sums nobody reads.
//
// R's decode (ge_decode: 255 squarings and 19 multiplies in one dependent
// chain) is now the longest chain of a signature.  Run inside the warp it
// would cost 32 lanes' issue slots for one result, so the kernel is two
// launches on the caller's stream: a prepare pass, one thread per
// signature, decodes R and recodes both scalars into a scratch record of
// MOCHI_TREE_SCRATCH_INTS int32 per signature (212 bytes); then the
// accumulate pass, one warp per signature, reads the record, sums the
// tree and compares.
//
// What bounds it: integer multiply throughput.  Counting what a signature
// needs (not the lanes that compute unread sums): R's decode (19
// multiplies, 255 squarings), 64 leaves of 3 multiplies, 64 level-1 mixed
// additions of 7, 63 complete additions of 9 (with the cached conversion's
// d2 multiply) and the 2 compare multiplies: 1,228 multiplies of 100
// 32x32->64 products and 255 squarings of 55, 136,825 multiply-adds.  The
// chain computes the same verdict with 105,725, so that is the function's
// bound for both kernels: against 64 per clock per SM x 132 SMs x 1.98
// GHz, 8192 signatures take at least 0.052 ms (0.067 at the tree's own
// count).  The warp issues more: 74 multiplies a lane, 2,368 a
// signature.  Bytes: 141 per signature in and out plus the 212-byte record
// written and read once, and one read of the tables: microseconds at 3.35
// TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include "comb_tree.cuh"

#define MOCHI_TREE_PREPARE_THREADS 128
#define MOCHI_TREE_WARPS 4  // signatures per block of the accumulate pass
#define MOCHI_TREE_THREADS (32 * MOCHI_TREE_WARPS)

__global__ void __launch_bounds__(MOCHI_TREE_PREPARE_THREADS)
    mochi_comb_tree_prepare_kernel(const int32_t* __restrict__ y_r,
                                   const int32_t* __restrict__ sign_r,
                                   const uint8_t* __restrict__ s_bytes,
                                   const uint8_t* __restrict__ h_bytes,
                                   int32_t* __restrict__ scratch, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t yr[17];
  uint8_t s[32], h[32];
  for (int k = 0; k < 17; ++k) yr[k] = __ldg(&y_r[(size_t)i * 17 + k]);
  for (int k = 0; k < 32; ++k) {
    s[k] = __ldg(&s_bytes[(size_t)i * 32 + k]);
    h[k] = __ldg(&h_bytes[(size_t)i * 32 + k]);
  }
  comb_tree_prepare(scratch + (size_t)i * MOCHI_TREE_SCRATCH_INTS, yr,
                    __ldg(&sign_r[i]), s, h);
}

__device__ __forceinline__ void shfl_down_fe(fe* r, const fe* f, int off) {
#pragma unroll
  for (int k = 0; k < 10; ++k) r->v[k] = __shfl_down_sync(0xffffffffu, f->v[k], off);
}

__global__ void __launch_bounds__(MOCHI_TREE_THREADS)
    mochi_comb_tree_kernel(const int32_t* __restrict__ table, int64_t rows,
                           const int32_t* __restrict__ key_idx,
                           const int32_t* __restrict__ bcomb,
                           const int32_t* __restrict__ scratch,
                           uint8_t* __restrict__ out, int n) {
  const int sig = blockIdx.x * MOCHI_TREE_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (sig >= n) return;  // the whole warp: no shuffle is left half-joined
  const int32_t* rec = scratch + (size_t)sig * MOCHI_TREE_SCRATCH_INTS;
  const int8_t* dig = (const int8_t*)(rec + MOCHI_TREE_SCRATCH_DIGITS);
  const int key = __ldg(&key_idx[sig]);
  ge_p3 acc, other;
  comb_tree_window(&acc, table, rows, key, bcomb, lane, dig[64 + lane], dig[lane]);
  comb_tree_window(&other, table, rows, key, bcomb, lane + 32, dig[96 + lane], dig[32 + lane]);
  comb_tree_add(&acc, &acc, &other);
#pragma unroll 1
  for (int off = 16; off >= 1; off >>= 1) {
    shfl_down_fe(&other.X, &acc.X, off);
    shfl_down_fe(&other.Y, &acc.Y, off);
    shfl_down_fe(&other.Z, &acc.Z, off);
    shfl_down_fe(&other.T, &acc.T, off);
    comb_tree_add(&acc, &acc, &other);
  }
  if (lane == 0) out[sig] = (uint8_t)comb_tree_finish(&acc, rec);
}

extern "C" {

// Both passes on `stream` (a cudaStream_t passed as a pointer); `scratch`
// holds n * MOCHI_TREE_SCRATCH_INTS int32.  Returns the first launch error
// (cudaGetLastError) so the caller sees a refused launch.
int mochi_comb_tree_verify(const void* table, long long rows,
                           const void* key_idx, const void* y_r,
                           const void* sign_r, const void* s_bytes,
                           const void* h_bytes, const void* bcomb,
                           void* scratch, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  mochi_comb_tree_prepare_kernel<<<(n + MOCHI_TREE_PREPARE_THREADS - 1) /
                                       MOCHI_TREE_PREPARE_THREADS,
                                   MOCHI_TREE_PREPARE_THREADS, 0, st>>>(
      (const int32_t*)y_r, (const int32_t*)sign_r, (const uint8_t*)s_bytes,
      (const uint8_t*)h_bytes, (int32_t*)scratch, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mochi_comb_tree_kernel<<<(n + MOCHI_TREE_WARPS - 1) / MOCHI_TREE_WARPS,
                           MOCHI_TREE_THREADS, 0, st>>>(
      (const int32_t*)table, (int64_t)rows, (const int32_t*)key_idx,
      (const int32_t*)bcomb, (const int32_t*)scratch, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill + stack) bytes per thread, static
// shared bytes and threads per block of the prepare pass (which = 0) or
// the accumulate pass (which = 1).
int mochi_comb_tree_verify_attrs(int which, int* regs, int* local_bytes,
                                 int* shared_bytes, int* threads) {
  cudaFuncAttributes a;
  const cudaError_t err =
      which == 0 ? cudaFuncGetAttributes(&a, mochi_comb_tree_prepare_kernel)
                 : cudaFuncGetAttributes(&a, mochi_comb_tree_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = which == 0 ? MOCHI_TREE_PREPARE_THREADS : MOCHI_TREE_THREADS;
  return 0;
}

}  // extern "C"
