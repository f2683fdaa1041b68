// Bounded last-mile lower-bound search for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bounded_search/kernel.py::
// lower_bound_kernel (driven by ops.py::lower_bound_windows): for sorted keys
// data[n] and a window per query, return the int32 lo + (count of keys below
// q in the window), which is the exact LB = lower_bound(data, q) wherever the
// window holds LB.  The window is [clip(lo, 0, n-1), min(hi, lo + max_width
// - 1, n)], position n as +inf; without hi it is [lo, lo + max_width).
//
// What bounds it on this card: distinct 32-byte sectors, read at the card's
// rate for scattered sectors (~26 G/s on an H100, whatever the order of the
// probes or their dependences; lookup.cuh and PERF.md say how that was
// found).  Each query reads 8 + lo (+ hi) bytes and writes 4, and its
// probes land in a 1.6 GB array (200M keys), where neighbouring queries
// share no sector.
//
// What the design does about it: every query runs its own trip count over
// its own window, and its first probes stay near the window's midpoint (the
// midpoint, then the edge of its sector, an L1 hit: kNearBlocks = 0 in
// lookup.cuh's window_lower_bound), because the windows of the learned
// families are centred on their prediction, so the answer is often in the
// midpoint's own sector.  It goes no further out than that sector: on the
// windows of PGM, RadixSpline and RBS the answer is spread across the window,
// and walking out sector by sector read more sectors than it saved there
// (PERF.md).  A lane whose search has ended is masked off and issues
// no loads.  Sorting the batch by window start, globally or inside a block,
// was timed and buys less than the write-back and the sort cost (PERF.md).
// The TPU binned queries into 2048-key tiles (capacity 256, a trash row, an
// overflow fallback) only to give VMEM static blocks; none of that is
// carried over: one thread per query searches global memory, one code path
// for every width.  The loop mirrors the plain version step for
// step (floor division, clip, position n as +inf, stop at an empty window),
// so the two agree bit for bit on every input.
//
// Keys are the codec's int64 or plain int32 (key_bytes 8 or 4), queries of
// the same type.  The int32 instantiation serves the paged KV cache's slot
// index (src/repro/serve/kv_cache.py::LearnedSlotIndex.lookup): cumulative
// sequence lengths, a few hundred to a few thousand, all in L2, with about
// a million flat slots as queries.  There a query reads 4 + 4 bytes and
// writes 4, and its probes hit L1 and L2: the bound is the queries' own
// bytes, no probe reaches device memory, and there is no sector to save, so
// that instance keeps the balanced search alone (kNearBlocks = -1), as
// before.  Searching int32 in place, rather than widening cum and the slots
// to int64, saves a cast kernel and its bytes on every lookup.  The TPU's
// path took its exact fallback (no tiles) for windows wider than 2048; this
// kernel has one code path for every width, and the answers are the same.
#include <climits>

#include "lookup.cuh"

namespace {

constexpr int kThreads = 256;
// How far the search walks out from a window's midpoint (lookup.cuh's
// window_lower_bound): int64 keys to the edge of the midpoint's sector, the
// int32 slot index not at all.
template <typename KeyT>
constexpr int kNearBlocks = sizeof(KeyT) == 8 ? 0 : -1;

template <typename KeyT, typename LoT, typename HiT>
__global__ void __launch_bounds__(kThreads)
    bounded_search_kernel(const KeyT* __restrict__ data, long long n,
                          const KeyT* __restrict__ queries,
                          const LoT* __restrict__ lo_in,
                          const HiT* __restrict__ hi_in, int* __restrict__ out,
                          long long m, long long max_width) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const long long hi = hi_in != nullptr ? (long long)hi_in[i] : LLONG_MAX;
  const lookup::Window w =
      lookup::clip_window((long long)lo_in[i], hi, n, max_width);
  out[i] = lookup::window_lower_bound<kNearBlocks<KeyT>>(data, (int)n,
                                                         queries[i], w);
}

struct Args {
  const void *data, *queries, *lo, *hi;
  void* out;
  long long n, m, max_width;
  void* stream;
};

template <typename KeyT, typename LoT, typename HiT>
int launch(const Args& a) {
  const long long blocks = (a.m + kThreads - 1) / kThreads;
  bounded_search_kernel<KeyT, LoT, HiT>
      <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)a.stream>>>(
          (const KeyT*)a.data, a.n, (const KeyT*)a.queries, (const LoT*)a.lo,
          (const HiT*)a.hi, (int*)a.out, a.m, a.max_width);
  return (int)cudaGetLastError();
}

template <typename KeyT, typename LoT>
int launch_hi(const Args& a, int hi_bytes) {
  if (hi_bytes == 4) return launch<KeyT, LoT, int>(a);
  if (hi_bytes == 8) return launch<KeyT, LoT, long long>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename KeyT>
int launch_lo(const Args& a, int lo_bytes, int hi_bytes) {
  if (lo_bytes == 4) return launch_hi<KeyT, int>(a, hi_bytes);
  if (lo_bytes == 8) return launch_hi<KeyT, long long>(a, hi_bytes);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// data and queries are int64 or int32 (key_bytes: 8 or 4); lo and hi are
// int32 or int64 (lo_bytes, hi_bytes: 4 or 8); hi may be null.
extern "C" int bounded_search(const void* data, long long n,
                              const void* queries, int key_bytes,
                              const void* lo, int lo_bytes, const void* hi,
                              int hi_bytes, void* out, long long m,
                              long long max_width, void* stream) {
  if (hi == nullptr) hi_bytes = lo_bytes;
  const Args a{data, queries, lo, hi, out, n, m, max_width, stream};
  if (key_bytes == 8) return launch_lo<long long>(a, lo_bytes, hi_bytes);
  if (key_bytes == 4) return launch_lo<int>(a, lo_bytes, hi_bytes);
  return (int)cudaErrorInvalidValue;
}
