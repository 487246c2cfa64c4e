// Batched Ed25519 cofactorless verification on Hopper: one signature per
// team of four lanes.
//
// Replaces the reference package's one Pallas kernel,
// crypto/pallas_verify.py::_kernel (the body is curve.verify_core, which is
// also what the reference's default XLA program runs).  The arithmetic lives
// in fe25519.cuh / ge25519.cuh / comb25519.cuh and the team's verify in
// verify25519.cuh, so the CPU tests compile the same code.
//
// What bounds it: integer multiply throughput.  The function is 3,431
// field operations a signature (two decodes of 274, the [0..8](-A) table's
// 65, 64 ladder windows of 44, the compare's 2): 1,534 squarings of 55
// 32x32->64 products and 1,897 multiplies of 100 in radix 2^25.5, 274,070
// multiply-adds, against the throughput table's 64 32-bit integer
// multiply(-add) results per clock per SM for compute capability 9.0 x 132
// SMs x the SM clock (1980 MHz on an H100 SXM: 1.67e13 a second, so 8192
// signatures take at least 0.134 ms).  The bytes moved (208 a signature in,
// 1 out, and one read of the 69,120-byte basepoint comb) are negligible.
//
// What the design does about it (verify25519.cuh has the details).  The
// one-thread kernel this replaces ran one signature's 3,431 operations as
// one dependent chain, with its [0..8](-A) table in local memory (255
// registers, 224 bytes of spills): any launch up to 16,384 lanes took ~3 ms,
// one thread's latency.  Here four lanes of a warp share a signature: the
// two decodes run side by side, [S]B is a fixed-base comb (64 mixed
// additions, no doublings) split over the four lanes, and every doubling
// and addition of [h](-A) is two steps of four independent operations, one
// a lane, exchanged through the team's shared scratch; the [1..8](-A)
// table lives there too, each lane holding the one coordinate its step
// reads.  A signature's chain drops to ~1,054 operations; the team issues
// 330,340 multiply-adds a signature (IMADS_ISSUED_PER_SIGNATURE in
// cuda_verify.py), 1.2x the function's, since lanes 2 and 3 repeat the
// decodes and a doubling's T is always computed.  Blocks are 64 threads (16
// teams, 1,988 bytes of shared scratch each).  Teams past the batch verify
// its last signature again and store nothing, so every team runs whole.
#include <cuda_runtime.h>
#include <stdint.h>

#include "verify25519.cuh"

#define MOCHI_VERIFY_TEAMS 16
#define MOCHI_VERIFY_THREADS (MOCHI_VERIFY_TEAMS * MOCHI_VT_TEAM)

__global__ void __launch_bounds__(MOCHI_VERIFY_THREADS)
    mochi_ed25519_verify_kernel(const int32_t* __restrict__ y_a,
                                const int32_t* __restrict__ sign_a,
                                const int32_t* __restrict__ y_r,
                                const int32_t* __restrict__ sign_r,
                                const uint8_t* __restrict__ s_bytes,
                                const uint8_t* __restrict__ h_bytes,
                                const int32_t* __restrict__ bcomb,
                                uint8_t* __restrict__ out, int n) {
  __shared__ vt_area area[MOCHI_VERIFY_TEAMS];
  const int lane = threadIdx.x & 31;
  const int team = blockIdx.x * MOCHI_VERIFY_TEAMS + threadIdx.x / MOCHI_VT_TEAM;
  // Inputs are batch-leading: the limbs of signature i are contiguous.
  const size_t i = team < n ? team : n - 1;
  vt_warp_lanes ln;
  ln.r = lane & (MOCHI_VT_TEAM - 1);
  ln.mask = ((1u << MOCHI_VT_TEAM) - 1) << (lane & ~(MOCHI_VT_TEAM - 1));
  const int ok = vt_verify(ln, &area[threadIdx.x / MOCHI_VT_TEAM], y_a + i * 17, __ldg(&sign_a[i]),
                           y_r + i * 17, __ldg(&sign_r[i]), s_bytes + i * 32, h_bytes + i * 32, bcomb);
  if (team < n && ln.r == 0) out[team] = (uint8_t)ok;
}

extern "C" {

// Launch on `stream` (a cudaStream_t passed as a pointer); returns
// cudaGetLastError() so the caller sees a refused launch.  b_tab: the
// basepoint comb, 576 Niels entries of 30 int32 (comb25519.cuh's layout).
int mochi_ed25519_verify(const void* y_a, const void* sign_a, const void* y_r,
                         const void* sign_r, const void* s_bytes,
                         const void* h_bytes, const void* b_tab, void* out,
                         int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + MOCHI_VERIFY_TEAMS - 1) / MOCHI_VERIFY_TEAMS;
    mochi_ed25519_verify_kernel<<<blocks, MOCHI_VERIFY_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        (const int32_t*)y_a, (const int32_t*)sign_a, (const int32_t*)y_r,
        (const int32_t*)sign_r, (const uint8_t*)s_bytes,
        (const uint8_t*)h_bytes, (const int32_t*)b_tab, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill + stack) bytes per thread, static
// shared bytes, the threads per block the kernel launches with, the lanes a
// signature and the dynamic shared bytes of a launch (none: the scratch is
// static).
int mochi_ed25519_verify_attrs(int* regs, int* local_bytes, int* shared_bytes,
                               int* threads, int* team, int* dynamic_shared_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, mochi_ed25519_verify_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = MOCHI_VERIFY_THREADS;
  *team = MOCHI_VT_TEAM;
  *dynamic_shared_bytes = 0;
  return 0;
}

}  // extern "C"
