// Device functions shared by the lookup kernels (sm_90a): the f32 RMI
// inference of one query (B2's arithmetic), and the window of one query and
// the bounded lower-bound search over it (B1's loop).
//
// Keys arrive in the port's codec: uint64 with the sign bit flipped, stored
// as int64, so a signed compare is the uint64 compare.  B1 also takes int32
// keys, compared as signed.
//
// What bounds the search on this card: distinct 32-byte sectors, at the
// card's rate for scattered sectors.  Timed on an H100 (PERF.md), a
// gather that reads the same probe addresses with no dependence between its
// loads takes B1's own time, and both cells run at ~26 G distinct sectors/s
// (0.83 TB/s of 32-byte sectors, a quarter of the streaming rate), whatever
// the probes per query.  Handing the batch over sorted by window start buys
// at most 16%, and writing each rank back to its query's position takes most
// of that back; sorting inside tiles of 1,024 to 16,384 queries buys 4-7%.
// So the loop reads fewer sectors instead: a learned model's window is
// centred on its prediction, and the answer is usually within a few keys of
// the midpoint (on wiki's RMI windows a median 5 keys from it), while a
// balanced search's second probe lands a quarter of the window away, in
// another sector.  `window_lower_bound` first probes near the midpoint.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lookup {

// ---------------------------------------------------------------------------
// B1: the window of one query and the search over it
// ---------------------------------------------------------------------------

// A query's window is [lo, lo + count) over data[0..n], where position n
// compares as +inf: lo = clip(lo, 0, n-1), and its last position is
// min(hi, lo + max_width - 1, n) (hi inclusive; pass INT64_MAX for none).
struct Window {
  int lo;
  unsigned count;
};

__device__ __forceinline__ Window clip_window(long long lo, long long hi,
                                              long long n,
                                              long long max_width) {
  lo = lo < 0 ? 0 : lo;
  lo = lo > n - 1 ? n - 1 : lo;
  long long last = lo + max_width - 1;
  last = hi < last ? hi : last;
  last = last < n ? last : n;
  const long long count = last - lo + 1;
  return {(int)lo, (unsigned)(count < 0 ? 0 : count)};
}

// A window of at most this many positions is searched near its midpoint
// first (`window_lower_bound`).  A wider one's answer is rarely near it: a
// tenth of amzn's RMI windows are wider, and a tenth of its answers lie
// 1.97M keys or more from their window's midpoint.
constexpr unsigned kNearMax = 4096;

// Whether data[p] < q, position n comparing as +inf (the load is clamped
// and always made, so the probe is branch-free).
template <typename KeyT>
__device__ __forceinline__ bool below(const KeyT* __restrict__ data,
                                      unsigned n, KeyT q, unsigned p) {
  return (__ldg(data + (p < n ? p : n - 1)) < q) & (p < n);
}

// lo plus the count of keys below q in the window.  KeyT is long long (the
// codec's keys) or int (int32 keys compared as signed, such as the KV
// cache's cumulative lengths).
//
// kNearBlocks < 0: the balanced search alone, the midpoint of what is left
// while it is non-empty, ceil(log2(count + 1)) probes, each one dependent
// load.  kNearBlocks >= 0, for a window of 1 to kNearMax positions: first
// the midpoint; then the edge of the midpoint's own 32-byte sector on the
// side the answer lies, an L1 hit; then up to kNearBlocks sectors 1, 3,
// 7, ... further out, while no probe has bracketed the answer; then the
// balanced search over what is left.  Every probe narrows the window to the
// side that holds the answer, so each form returns the same count.
template <int kNearBlocks, typename KeyT>
__device__ __forceinline__ int window_lower_bound(
    const KeyT* __restrict__ data, int n, KeyT q, Window w) {
  constexpr unsigned kSector = 32 / sizeof(KeyT);
  const unsigned un = (unsigned)n;
  unsigned a = (unsigned)w.lo, b = a + w.count;
  if (kNearBlocks >= 0 && w.count - 1u < kNearMax) {
    const unsigned mid = a + (w.count >> 1);
    unsigned step = kSector;
    if (below(data, un, q, mid)) {
      a = mid + 1;
      unsigned p = mid | (kSector - 1);
      for (int k = 0; k <= kNearBlocks && p < b; ++k) {
        if (p > mid) {
          if (!below(data, un, q, p)) {
            b = p;
            break;
          }
          a = p + 1;
        }
        p += step;
        step <<= 1;
      }
    } else {
      b = mid;
      unsigned p = mid & ~(kSector - 1);
      for (int k = 0; k <= kNearBlocks && p >= a; ++k) {
        if (p < mid) {
          if (below(data, un, q, p)) {
            a = p + 1;
            break;
          }
          b = p;
        }
        if (p < step) break;
        p -= step;
        step <<= 1;
      }
    }
  }
  while (a < b) {
    const unsigned mid = a + ((b - a) >> 1);
    const bool right = below(data, un, q, mid);
    a = right ? mid + 1 : a;
    b = right ? b : mid;
  }
  return (int)a;
}

// ---------------------------------------------------------------------------
// B2: f32 two-stage RMI inference of one query
// ---------------------------------------------------------------------------

struct RmiModel {
  float c0, c1, x0, inv_range, scale, hi_clamp;
  int branching, n;
};

// Stage 1: the query's normalised coordinate u and its stage-2 bucket.
// Every product and sum is written with an _rn intrinsic: nvcc would
// otherwise contract a*u+b into an FMA, and the error table is valid only
// under the arithmetic that verified it (separate torch multiplies and
// adds, which these intrinsics reproduce bit for bit).
__device__ __forceinline__ int rmi_bucket(const RmiModel& m, long long q,
                                          float& u) {
  // codec: flip the sign bit back to the uint64 key, split into halves
  const unsigned long long k = (unsigned long long)q ^ 0x8000000000000000ULL;
  const float qf = __fadd_rn(
      __fmul_rn(__uint2float_rn((unsigned)(k >> 32)), 4294967296.0f),
      __uint2float_rn((unsigned)(k & 0xFFFFFFFFULL)));
  u = __fmul_rn(__fsub_rn(qf, m.x0), m.inv_range);
  const float p1 = __fadd_rn(__fmul_rn(m.c0, u), m.c1);
  float s = floorf(__fmul_rn(p1, m.scale));
  s = fminf(fmaxf(s, 0.0f), (float)(m.branching - 1));
  return (int)s;
}

// Stage 2: pred = a2*u + b2, and the bounds clip(floor(pred) - err, 0, n),
// clip(ceil(pred) + err, 0, n).
__device__ __forceinline__ void rmi_bounds_of(const RmiModel& m, float u,
                                              float a2, float b2, int err,
                                              int& lo, int& hi) {
  float pred = __fadd_rn(__fmul_rn(a2, u), b2);
  pred = fminf(fmaxf(pred, -1.0f), m.hi_clamp);  // guard the int32 casts
  lo = (int)floorf(pred) - err;
  lo = lo < 0 ? 0 : (lo > m.n ? m.n : lo);
  hi = (int)ceilf(pred) + err;
  hi = hi < 0 ? 0 : (hi > m.n ? m.n : hi);
}

// One query's bounds, its stage-2 model gathered from the three tables.
__device__ __forceinline__ void rmi_bounds_one(
    const RmiModel& m, const float* __restrict__ a2,
    const float* __restrict__ b2, const int* __restrict__ err, long long q,
    int& lo, int& hi) {
  float u;
  const int bkt = rmi_bucket(m, q, u);
  rmi_bounds_of(m, u, __ldg(a2 + bkt), __ldg(b2 + bkt), __ldg(err + bkt), lo,
                hi);
}

}  // namespace lookup
