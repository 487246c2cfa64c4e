// Known-signer (comb) Ed25519 verification on Hopper with the tree
// accumulation: one launch, a decode warp beside MOCHI_TREE_LANES lanes a
// signature summing its window points, one warp a scheduler.
//
// Replaces the reference package's comb.verify_comb_prepared with
// impl="tree" (crypto/comb.py:428-472, _tree_accumulate :354), selected by
// MOCHI_COMB_IMPL=tree.  The arithmetic lives in comb_tree.cuh (the lane
// order of the sum, over comb_team.cuh's window sum and comb25519.cuh's
// gathers), so the CPU tests compile the same code with g++.  Where the
// reference selects the basepoint rows with a one-hot float32 matmul, this
// kernel loads the row its digit names: integer arithmetic only.
//
// What bounds it: integer multiply throughput.  The function's bound is
// the chain's (comb.cu): 917 multiplies of 100 32x32->64 products and 255
// squarings of 55, 105,725 multiply-adds a signature, against 64 per clock
// per SM x 132 SMs x 1.98 GHz: 8192 signatures take at least 0.052 ms.
// This kernel issues more: each of the signature's MOCHI_TREE_LANES lanes
// makes its 128 / LANES mixed additions of 7 multiplies, every level of the
// sum across the lanes (9) and the compare's 2, and R's decode 19
// multiplies and 255 squarings, on a warp whose lanes past the block's
// signatures decode too: with 4 lanes 976 multiplies and 4/3 of a decode,
// 118,833 multiply-adds a signature.  Bytes: 141 a signature
// in and out and one read of the tables, which stay in the 50 MB L2:
// microseconds at 3.35 TB/s.
//
// Design.  The tree exists to cut a signature's dependent depth, and on
// this card the longest chain is R's decode (ge_decode: 255 squarings and
// 19 multiplies in one dependent chain), not the 128-point sum.  So a block
// of four warps serves 24 signatures with two roles, run at once:
//   * warp 0 decodes: lane l decodes R of the block's signature l and
//     leaves x_R, y_R and the verdict in shared memory (21 words a
//     signature; lanes 24-31 decode the next signatures for nothing);
//   * warps 1-3 sum: lane j of a signature's MOCHI_TREE_LANES
//     neighbouring lanes mixed-adds both tables' entries of its 64 / LANES
//     windows from the identity (its digits recoded from s and h on the fly,
//     with the carry from the windows below), then log2(LANES) levels of
//     ge_to_cached + ge_add fold the partner lane's point, taken by
//     __shfl_down_sync within the signature's lanes, into its own.
// After one barrier, lane 0 of each signature compares its sum with R and
// stores the verdict.  A decode lane's chain (274 operations) and a summing
// lane's (with 4 lanes: 32 x 7 + 2 x 9 + 2 = 244 multiplies) about
// balance, so a small launch runs at about the decode's latency.  Four
// warps, one on each of the SM's four schedulers: a fifth (32 signatures a
// block) shares the decode warp's scheduler, and measured slower up to
// 2,752 lanes and from 65536, faster only at 8192-16384, where blocks of
// 24 fill the SMs unevenly (PERF.md).  The field multiply and squaring are
// compiled once and called by value (MOCHI_FE_CALLED, fe25519.cuh), as
// comb.cu's.  A role is a whole warp, so only the compare diverges, and
// every lane reaches every shuffle and the barrier: signatures past the
// batch repeat its last one and store nothing.
#include <cuda_runtime.h>
#include <stdint.h>

// One copy of the field multiply and squaring, called by value (fe25519.cuh).
#define MOCHI_FE_CALLED
#include "comb_tree.cuh"

#define MOCHI_TREE_SUM_WARPS 3
// signatures a block: at most one a lane of the decode warp
#define MOCHI_TREE_SIGS (MOCHI_TREE_SUM_WARPS * 32 / MOCHI_TREE_LANES)
#define MOCHI_TREE_THREADS (32 * (1 + MOCHI_TREE_SUM_WARPS))

// R of one signature as the decode warp leaves it: 21 words (odd, so that
// the decode warp's 32 lanes write a given word to 32 different banks).
struct tree_r {
  int32_t x[10], y[10];
  int32_t ok;
};

__global__ void __launch_bounds__(MOCHI_TREE_THREADS)
    mochi_comb_tree_kernel(const int32_t* __restrict__ table, int64_t rows,
                           const int32_t* __restrict__ key_idx,
                           const int32_t* __restrict__ y_r,
                           const int32_t* __restrict__ sign_r,
                           const uint8_t* __restrict__ s_bytes,
                           const uint8_t* __restrict__ h_bytes,
                           const int32_t* __restrict__ bcomb,
                           uint8_t* __restrict__ out, int n) {
  __shared__ tree_r rs[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = blockIdx.x * MOCHI_TREE_SIGS;
  // this thread's signature in the block, and its lane among the signature's
  const int local = warp == 0 ? lane : (warp - 1) * (32 / MOCHI_TREE_LANES) + lane / MOCHI_TREE_LANES;
  const tree_warp_lanes ln = {lane % MOCHI_TREE_LANES};
  // Inputs are batch-leading: the limbs of signature i are contiguous.
  const size_t i = first + local < n ? first + local : n - 1;
  ge_p3 q;
  if (warp == 0) {
    ge_p3 r;
    const int ok = ge_decode(&r, y_r + i * 17, 1, __ldg(&sign_r[i]));
    for (int k = 0; k < 10; ++k) {
      rs[lane].x[k] = r.X.v[k];
      rs[lane].y[k] = r.Y.v[k];
    }
    rs[lane].ok = ok;
  } else {
    const tree_byte_rows src = {table, rows, __ldg(&key_idx[i]), s_bytes + i * 32, h_bytes + i * 32, bcomb};
    comb_tree_sum_lanes(ln, &q, src);
  }
  __syncthreads();
  if (warp != 0 && ln.j == 0 && first + local < n) {
    fe xr, yr;
    for (int k = 0; k < 10; ++k) {
      xr.v[k] = rs[local].x[k];
      yr.v[k] = rs[local].y[k];
    }
    out[first + local] = (uint8_t)comb_tree_compare(&q, &xr, &yr, rs[local].ok);
  }
}

extern "C" {

// Launch on `stream` (a cudaStream_t passed as a pointer); returns
// cudaGetLastError() so the caller sees a refused launch.
int mochi_comb_tree_verify(const void* table, long long rows, const void* key_idx,
                           const void* y_r, const void* sign_r, const void* s_bytes,
                           const void* h_bytes, const void* bcomb, void* out, int n,
                           void* stream) {
  if (n > 0) {
    const int blocks = (n + MOCHI_TREE_SIGS - 1) / MOCHI_TREE_SIGS;
    mochi_comb_tree_kernel<<<blocks, MOCHI_TREE_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)table, (int64_t)rows, (const int32_t*)key_idx, (const int32_t*)y_r,
        (const int32_t*)sign_r, (const uint8_t*)s_bytes, (const uint8_t*)h_bytes,
        (const int32_t*)bcomb, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill + stack) bytes per thread, static
// shared bytes, the threads per block the kernel launches with, the lanes a
// signature and the dynamic shared bytes of a launch (none: R's rows are
// static).
int mochi_comb_tree_verify_attrs(int* regs, int* local_bytes, int* shared_bytes,
                                 int* threads, int* team, int* dynamic_shared_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, mochi_comb_tree_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = MOCHI_TREE_THREADS;
  *team = MOCHI_TREE_LANES;
  *dynamic_shared_bytes = 0;
  return 0;
}

}  // extern "C"
