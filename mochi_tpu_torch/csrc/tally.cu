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
// What the design does about it: nothing clever, on purpose.  One lane per
// thread, one global atomicAdd per accepted vote; the entry point zeroes the
// slots with cudaMemsetAsync on the same stream, so one call computes the
// whole sum.  Block-private shared-memory histograms, or fusing the tally
// into the verify kernels' epilogue, are for when a profile shows the tally.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tally.cuh"

#define MOCHI_TALLY_THREADS 256

__global__ void __launch_bounds__(MOCHI_TALLY_THREADS)
    mochi_quorum_tally_kernel(const uint8_t* __restrict__ bitmap,
                              const uint8_t* __restrict__ pre_ok,
                              const int32_t* __restrict__ group_ids, int n,
                              int n_groups, int32_t* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (bitmap[i] == 0 || pre_ok[i] == 0) return;
  const int32_t g = quorum_slot(group_ids[i], n_groups);
  if (g >= 0) atomicAdd(&counts[g], 1);
}

__global__ void __launch_bounds__(MOCHI_TALLY_THREADS)
    mochi_quorum_commit_kernel(const int32_t* __restrict__ counts,
                               int n_groups, int threshold,
                               uint8_t* __restrict__ committed) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n_groups) committed[g] = counts[g] >= threshold ? 1 : 0;
}

extern "C" {

// counts[g] = accepted votes of slot g (zeroed here first), all on `stream`
// (a cudaStream_t passed as a pointer); returns cudaGetLastError() so the
// caller sees a refused launch.
int mochi_quorum_tally(const void* bitmap, const void* pre_ok,
                       const void* group_ids, int n, int n_groups, void* counts,
                       void* stream) {
  if (n_groups > 0) {
    const cudaError_t err = cudaMemsetAsync(
        counts, 0, sizeof(int32_t) * (size_t)n_groups, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0 && n_groups > 0) {
    const int blocks = (n + MOCHI_TALLY_THREADS - 1) / MOCHI_TALLY_THREADS;
    mochi_quorum_tally_kernel<<<blocks, MOCHI_TALLY_THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const uint8_t*)bitmap, (const uint8_t*)pre_ok,
        (const int32_t*)group_ids, n, n_groups, (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}

// committed[g] = counts[g] >= threshold, on `stream`.
int mochi_quorum_commit(const void* counts, int n_groups, int threshold,
                        void* committed, void* stream) {
  if (n_groups > 0) {
    const int blocks = (n_groups + MOCHI_TALLY_THREADS - 1) / MOCHI_TALLY_THREADS;
    mochi_quorum_commit_kernel<<<blocks, MOCHI_TALLY_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        (const int32_t*)counts, n_groups, threshold, (uint8_t*)committed);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill + stack) bytes per thread, static
// shared bytes and the threads per block of the tally kernel.
int mochi_quorum_tally_attrs(int* regs, int* local_bytes, int* shared_bytes,
                             int* threads) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, mochi_quorum_tally_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = MOCHI_TALLY_THREADS;
  return 0;
}

}  // extern "C"
