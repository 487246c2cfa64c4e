// The quorum slot of one vote, shared by the tally kernel (tally.cu) and the
// host build the CPU tests compile with g++.
//
// The reference sums votes with jnp.zeros(n_groups).at[ids].add(v,
// mode="drop"), whose index rule is NumPy's before the drop: an id in
// [-n_groups, -1] wraps to id + n_groups, and only then is an id outside
// [0, n_groups) dropped.  So -1 votes for the last slot, while n_groups and
// -n_groups - 1 vote for none.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define MOCHI_TALLY_HD __host__ __device__ __forceinline__
#else
#define MOCHI_TALLY_HD static inline
#endif

// The slot lane `id` votes for among `n_groups`, or -1 when it is dropped.
// id + n_groups cannot overflow: it is only formed for id < 0 <= n_groups.
MOCHI_TALLY_HD int32_t quorum_slot(int32_t id, int32_t n_groups) {
  if (id < 0) id += n_groups;
  return (id >= 0 && id < n_groups) ? id : -1;
}
