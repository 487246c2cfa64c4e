// The quorum slot of one vote, and a warp's walk of the tally, shared by the
// tally kernel (tally.cu) and the host build the CPU tests compile with g++.
//
// The reference sums votes with jnp.zeros(n_groups).at[ids].add(v,
// mode="drop"), whose index rule is NumPy's before the drop: an id in
// [-n_groups, -1] wraps to id + n_groups, and only then is an id outside
// [0, n_groups) dropped.  So -1 votes for the last slot, while n_groups and
// -n_groups - 1 vote for none.
//
// The walk is written once over a lane policy, as comb_team.cuh's team is:
// on the card the policy is one thread a lane and the warp intrinsics
// (tally.cu's tally_warp_lanes); under g++ tally_serial_warp below plays
// all 32 lanes in one thread, each per-lane value an array of 32, and
// emulates __match_any_sync, __ballot_sync, __any_sync and __shfl_sync, so
// the CPU tests run the very walk the kernel runs.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define MOCHI_TALLY_HD __host__ __device__ __forceinline__
#else
#define MOCHI_TALLY_HD static inline
#endif

#if defined(__CUDA_ARCH__)
#define MOCHI_TALLY_UNROLL _Pragma("unroll")
#define MOCHI_TALLY_POPC(x) __popc(x)
#define MOCHI_TALLY_LDG(p) __ldg(p)
#define MOCHI_TALLY_LDCG(p) __ldcg(p)
#else
#define MOCHI_TALLY_UNROLL
#define MOCHI_TALLY_POPC(x) __builtin_popcount(x)
#define MOCHI_TALLY_LDG(p) (*(p))
#define MOCHI_TALLY_LDCG(p) (*(p))
#endif

// Steps of 32 lanes a warp walks: 256 consecutive lanes a warp.
#define MOCHI_TALLY_STEPS 8

// The slot lane `id` votes for among `n_groups`, or -1 when it is dropped.
// id + n_groups cannot overflow: it is only formed for id < 0 <= n_groups.
MOCHI_TALLY_HD int32_t quorum_slot(int32_t id, int32_t n_groups) {
  if (id < 0) id += n_groups;
  return (id >= 0 && id < n_groups) ? id : -1;
}

// One step of 32 lanes.  Lanes of equal slot form a group (match_any); a
// group's votes are popc(ballot(vote) & group), and its lowest lane adds
// them to the slot with one add.  The group of lane 31's slot (the tail)
// adds nothing yet: its run may go on in the next step, so its votes join
// the carried run (*cs, *cc), which is added when its slot changes.  When
// the carried slot shows up in a group that is not the tail, that group's
// leader adds the carried votes with its own; when it does not show up at
// all, lane 0 adds them alone.  So each slot gets at most one add a step,
// and sorted runs get one a run a warp.  Dropped lanes (slot -1) add
// nothing; a group with no vote adds nothing.  (*cs, *cc) are the same on
// every lane.  `step` only labels the add for the serial twin's log.
template <class LN>
MOCHI_TALLY_HD void tally_step(const LN& ln, const int32_t* slot, const int* vote, int32_t* cs, int32_t* cc,
                               int32_t* counts, int step) {
  uint32_t group[LN::N];
  int32_t votes[LN::N];
  int hit[LN::N];
  ln.match(slot, group);
  const uint32_t voted = ln.ballot(vote);
  for (int j = 0; j < LN::N; ++j) {
    votes[j] = MOCHI_TALLY_POPC(voted & group[j]);
    hit[j] = slot[j] == *cs;
  }
  const int32_t tail = ln.last(slot), tail_votes = ln.last(votes);
  const bool carried_here = ln.any(hit);
  for (int j = 0; j < LN::N; ++j) {
    const int lane = ln.lane(j);
    const int32_t s = slot[j];
    const bool leader = (group[j] & ((1u << lane) - 1u)) == 0u;
    if (leader && s >= 0 && s != tail) {
      const int32_t k = votes[j] + (s == *cs ? *cc : 0);
      if (k) ln.add(counts, s, k, step);
    }
    if (lane == 0 && *cs >= 0 && *cs != tail && !carried_here && *cc) ln.add(counts, *cs, *cc, step);
  }
  *cc = tail < 0 ? 0 : tail_votes + (tail == *cs ? *cc : 0);
  *cs = tail;
}

// A warp's walk over lanes [base, base + 32 MOCHI_TALLY_STEPS): every step's
// loads first (a warp waits for memory once), then the steps, then the
// carried run's add.  A lane at or past n takes slot -1 and no vote; it
// still reaches every intrinsic, so nothing returns early.
template <class LN>
MOCHI_TALLY_HD void tally_warp_walk(const LN& ln, const uint8_t* bitmap, const uint8_t* pre_ok,
                                    const int32_t* group_ids, int64_t base, int n, int32_t n_groups,
                                    int32_t* counts) {
  int32_t slot[MOCHI_TALLY_STEPS][LN::N];
  int vote[MOCHI_TALLY_STEPS][LN::N];
  MOCHI_TALLY_UNROLL
  for (int s = 0; s < MOCHI_TALLY_STEPS; ++s) {
    for (int j = 0; j < LN::N; ++j) {
      const int64_t i = base + 32 * s + ln.lane(j);
      const bool in = i < n;
      slot[s][j] = in ? quorum_slot(MOCHI_TALLY_LDG(&group_ids[i]), n_groups) : -1;
      vote[s][j] = in && ((MOCHI_TALLY_LDG(&bitmap[i]) != 0) & (MOCHI_TALLY_LDG(&pre_ok[i]) != 0));
    }
  }
  int32_t cs = -1, cc = 0;
  MOCHI_TALLY_UNROLL
  for (int s = 0; s < MOCHI_TALLY_STEPS; ++s) tally_step(ln, slot[s], vote[s], &cs, &cc, counts, s);
  for (int j = 0; j < LN::N; ++j)
    if (ln.lane(j) == 0 && cs >= 0 && cc) ln.add(counts, cs, cc, MOCHI_TALLY_STEPS);
}

// Slots a thread of the fused kernel's last block loads before it stores
// any: its loads are in flight together (a byte store may alias the
// counts, so loads and stores interleaved would wait for each load).
#define MOCHI_COMMIT_CHUNK 16

// committed[g] = counts[g] >= threshold for g = first, first + stride, ...:
// the fused kernel's last block, once every block's adds are in (counts
// read past L1).
MOCHI_TALLY_HD void tally_commit_slots(const int32_t* counts, int32_t n_groups, int threshold,
                                       uint8_t* committed, int first, int stride) {
  for (int64_t g0 = first; g0 < n_groups; g0 += (int64_t)MOCHI_COMMIT_CHUNK * stride) {
    int32_t c[MOCHI_COMMIT_CHUNK];
    MOCHI_TALLY_UNROLL
    for (int k = 0; k < MOCHI_COMMIT_CHUNK; ++k) {
      const int64_t g = g0 + (int64_t)k * stride;
      c[k] = g < n_groups ? MOCHI_TALLY_LDCG(&counts[g]) : 0;
    }
    MOCHI_TALLY_UNROLL
    for (int k = 0; k < MOCHI_COMMIT_CHUNK; ++k) {
      const int64_t g = g0 + (int64_t)k * stride;
      if (g < n_groups) committed[g] = c[k] >= threshold ? 1 : 0;
    }
  }
}

#if !defined(__CUDACC__)
// The serial twin: one thread plays the warp's 32 lanes.  Each add is also
// logged as (warp, step, slot, votes) into `log` (4 ints an add, room for
// `cap` adds; `*n_log` counts every add, logged or not).
struct tally_serial_warp {
  static constexpr int N = 32;
  int warp;
  int32_t* log;
  int cap;
  int* n_log;
  int lane(int j) const { return j; }
  void match(const int32_t* s, uint32_t* m) const {
    for (int j = 0; j < N; ++j) {
      m[j] = 0;
      for (int i = 0; i < N; ++i) m[j] |= (uint32_t)(s[i] == s[j]) << i;
    }
  }
  uint32_t ballot(const int* v) const {
    uint32_t m = 0;
    for (int i = 0; i < N; ++i) m |= (uint32_t)(v[i] != 0) << i;
    return m;
  }
  int any(const int* p) const {
    for (int i = 0; i < N; ++i)
      if (p[i]) return 1;
    return 0;
  }
  int32_t last(const int32_t* x) const { return x[N - 1]; }
  void add(int32_t* counts, int32_t slot, int32_t k, int step) const {
    counts[slot] += k;
    if (*n_log < cap) {
      int32_t* e = log + 4 * *n_log;
      e[0] = warp, e[1] = step, e[2] = slot, e[3] = k;
    }
    ++*n_log;
  }
};
#endif
