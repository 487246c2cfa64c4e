// The 2f+1 quorum tally on Hopper: a segment sum of accepted votes into
// quorum slots, then the threshold compare.
//
// Replaces the tally inside the reference package's sharded quorum step,
// mochi_tpu/parallel/sharded.py::make_quorum_step (`local`):
// zeros(n_groups).at[group_ids].add(bitmap, mode="drop"), the psum over the
// mesh (NCCL's all_reduce in the port, outside any kernel) and
// counts >= threshold.  Unlike the reference, a vote counts only where the
// device bitmap AND the host prechecks (pre_ok) accept it: the reference
// tallies the raw bitmap, which is True for some lanes the host rejected.
//
// What bounds it: bytes, and below a few hundred thousand lanes the launch
// itself.  A lane reads 6 bytes (verdict, precheck, group id) and the slots
// are written once: 66,048 lanes and 1,537 slots are ~0.4 MB, ~0.12 us at
// 3.35 TB/s, far under one launch's few microseconds.  The atomics are
// integer adds, so the sum is exact and independent of their order.
//
// What the design does about it: a warp sums before it adds.  On the main
// path 43 neighbouring lanes (one certificate's grants) vote for one slot,
// and one atomicAdd a vote sent a warp's 32 same-address atomics to the L2,
// which serialises them.  Here each warp walks 8 steps of 32 consecutive
// lanes (tally.cuh's tally_warp_walk): __match_any_sync groups the lanes of
// a step by slot, popc(ballot & group) counts a group's votes, and the
// group's lowest lane adds them with one atomic; the run that reaches the
// step's last lane is carried in a register into the next step, so sorted
// runs cost one atomic a run a warp.  Ids in any order stay exact (they
// only take more atomics).  A warp's 32 byte-wide loads are one 32-byte
// sector already, so the loads stay scalar and any data pointer works.
// Every step's loads are issued before the first step, and no lane returns
// early: lanes past n take a dropped slot and no vote.  The slots are
// zeroed with cudaMemsetAsync on the same stream (a grid-wide zero inside
// the kernel would need a grid barrier).
//
// The fused entry point (mochi_quorum_tally_commit) also writes the commit
// where the counts are final, a one-slice mesh: every block fences its
// atomics and takes a ticket (one int past the slots, zeroed by the same
// memset); the block that takes the last ticket reads the counts past L1
// (16 loads a thread in flight before its stores) and writes
// counts >= threshold.  That saves the commit's launch and its ctypes call
// on the host; on the card the fence, the ticket and that read add
// ~2.5-3 us to the kernel, more than the commit's own node in a CUDA graph
// (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tally.cuh"

#define MOCHI_TALLY_WARPS 4  // warps a block
#define MOCHI_TALLY_THREADS (32 * MOCHI_TALLY_WARPS)
#define MOCHI_COMMIT_THREADS 256
#define MOCHI_FULL_WARP 0xffffffffu

// The card's lanes: one thread a lane, every lane of the warp at every
// intrinsic.  (Host-device members, as the walk that calls them; the host
// pass never runs them.)
#if defined(__CUDA_ARCH__)
#define MOCHI_ON_CARD(x) x
#else
#define MOCHI_ON_CARD(x) 0
#endif
struct tally_warp_lanes {
  static constexpr int N = 1;
  int l;
  MOCHI_TALLY_HD int lane(int) const { return l; }
  MOCHI_TALLY_HD void match(const int32_t* s, uint32_t* m) const {
    m[0] = MOCHI_ON_CARD(__match_any_sync(MOCHI_FULL_WARP, s[0]));
  }
  MOCHI_TALLY_HD uint32_t ballot(const int* v) const { return MOCHI_ON_CARD(__ballot_sync(MOCHI_FULL_WARP, v[0])); }
  MOCHI_TALLY_HD int any(const int* p) const { return MOCHI_ON_CARD(__any_sync(MOCHI_FULL_WARP, p[0])); }
  MOCHI_TALLY_HD int32_t last(const int32_t* x) const { return MOCHI_ON_CARD(__shfl_sync(MOCHI_FULL_WARP, x[0], 31)); }
  MOCHI_TALLY_HD void add(int32_t* counts, int32_t slot, int32_t k, int) const {
    MOCHI_ON_CARD(atomicAdd(&counts[slot], k));
  }
};

// kCommit: the fused kernel, `counts` holding n_groups slots and the ticket.
template <bool kCommit>
__global__ void __launch_bounds__(MOCHI_TALLY_THREADS)
    mochi_quorum_tally_kernel(const uint8_t* __restrict__ bitmap, const uint8_t* __restrict__ pre_ok,
                              const int32_t* __restrict__ group_ids, int n, int n_groups,
                              int32_t* __restrict__ counts, int threshold, uint8_t* __restrict__ committed) {
  const tally_warp_lanes ln{(int)(threadIdx.x & 31)};
  const int64_t warp = (int64_t)blockIdx.x * MOCHI_TALLY_WARPS + (threadIdx.x >> 5);
  tally_warp_walk(ln, bitmap, pre_ok, group_ids, warp * 32 * MOCHI_TALLY_STEPS, n, n_groups, counts);
  if constexpr (kCommit) {
    __shared__ int last;
    __threadfence();  // this thread's adds before the block's ticket
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&counts[n_groups], 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (last) tally_commit_slots(counts, n_groups, threshold, committed, threadIdx.x, MOCHI_TALLY_THREADS);
  }
}

__global__ void __launch_bounds__(MOCHI_COMMIT_THREADS)
    mochi_quorum_commit_kernel(const int32_t* __restrict__ counts,
                               int n_groups, int threshold,
                               uint8_t* __restrict__ committed) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n_groups) committed[g] = counts[g] >= threshold ? 1 : 0;
}

// Zero `words` int32 of `counts`, then one launch of the tally kernel over
// n lanes (at least one block, so that the fused kernel's commit is
// written for n = 0).
template <bool kCommit>
static int tally_launch(const void* bitmap, const void* pre_ok, const void* group_ids, int n, int n_groups,
                        int threshold, void* counts, void* committed, size_t words, cudaStream_t stream) {
  if (words > 0) {
    const cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * words, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t lanes_a_block = (int64_t)MOCHI_TALLY_THREADS * MOCHI_TALLY_STEPS;
  const int blocks = n > 0 ? (int)((n + lanes_a_block - 1) / lanes_a_block) : 1;
  mochi_quorum_tally_kernel<kCommit><<<blocks, MOCHI_TALLY_THREADS, 0, stream>>>(
      (const uint8_t*)bitmap, (const uint8_t*)pre_ok, (const int32_t*)group_ids, n, n_groups,
      (int32_t*)counts, threshold, (uint8_t*)committed);
  return (int)cudaGetLastError();
}

extern "C" {

// counts[g] = accepted votes of slot g (zeroed here first), all on `stream`
// (a cudaStream_t passed as a pointer); returns cudaGetLastError() so the
// caller sees a refused launch.
int mochi_quorum_tally(const void* bitmap, const void* pre_ok,
                       const void* group_ids, int n, int n_groups, void* counts,
                       void* stream) {
  return tally_launch<false>(bitmap, pre_ok, group_ids, n, n_groups, 0, counts, nullptr, (size_t)n_groups,
                             (cudaStream_t)stream);
}

// The tally and committed[g] = counts[g] >= threshold in one launch, on
// `stream`.  `counts` holds n_groups + 1 int32: the slots, then the
// blocks' ticket.
int mochi_quorum_tally_commit(const void* bitmap, const void* pre_ok, const void* group_ids, int n,
                              int n_groups, int threshold, void* counts, void* committed, void* stream) {
  return tally_launch<true>(bitmap, pre_ok, group_ids, n, n_groups, threshold, counts, committed,
                            (size_t)n_groups + 1, (cudaStream_t)stream);
}

// committed[g] = counts[g] >= threshold, on `stream`.
int mochi_quorum_commit(const void* counts, int n_groups, int threshold,
                        void* committed, void* stream) {
  if (n_groups > 0) {
    const int blocks = (n_groups + MOCHI_COMMIT_THREADS - 1) / MOCHI_COMMIT_THREADS;
    mochi_quorum_commit_kernel<<<blocks, MOCHI_COMMIT_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        (const int32_t*)counts, n_groups, threshold, (uint8_t*)committed);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill + stack) bytes per thread, static
// shared bytes and the threads per block of the tally kernel (fused != 0:
// the fused one).
int mochi_quorum_tally_attrs(int fused, int* regs, int* local_bytes, int* shared_bytes, int* threads) {
  cudaFuncAttributes a;
  const cudaError_t err = fused ? cudaFuncGetAttributes(&a, mochi_quorum_tally_kernel<true>)
                                : cudaFuncGetAttributes(&a, mochi_quorum_tally_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = MOCHI_TALLY_THREADS;
  return 0;
}

}  // extern "C"
