// Bounded last-mile lower-bound search for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bounded_search/kernel.py::
// lower_bound_kernel (driven by ops.py::lower_bound_windows): for sorted keys
// data[n] and a window start lo per query with LB in [lo, lo + max_width),
// return the exact int32 LB = lower_bound(data, q).
//
// Keys arrive in the port's codec: uint64 with the sign bit flipped, stored
// as int64, so a signed compare is the uint64 compare.
//
// What bounds it on this card: memory latency and sectors.  Each query reads
// 8 + lo bytes and writes 4, then makes lb_steps(max_width) dependent probes
// into a 1.6 GB array (200M keys); the first probes of neighbouring queries
// share no sector, so each costs a 32-byte sector from HBM or L2.
//
// What the design does about it: the TPU binned queries into 2048-key tiles
// (capacity 256, a trash row, an overflow fallback) only to give VMEM static
// blocks; none of that is carried over.  One thread per query runs the
// branchless search straight over global memory: no shared memory, no sort,
// one code path for every width (the TPU's wide-window and overflow
// fallbacks included), and enough threads in flight (m = 1M) to hide the
// probe latency.  The loop mirrors the plain version step for step
// (fixed trip count, floor division, clip, position n as +inf), so the two
// agree bit for bit on every input, not only where the window holds LB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename LoT>
__global__ void bounded_search_kernel(const long long* __restrict__ data,
                                      long long n,
                                      const long long* __restrict__ queries,
                                      const LoT* __restrict__ lo_in,
                                      int* __restrict__ out, long long m,
                                      long long max_width, int steps) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int n32 = (int)n;
  // lo clipped to [0, n-1]; the window is [lo, min(lo + max_width, n) - 1]
  long long lo64 = (long long)lo_in[i];
  lo64 = lo64 < 0 ? 0 : lo64;
  lo64 = lo64 > n - 1 ? n - 1 : lo64;
  long long end = lo64 + max_width;
  end = end < n ? end : n;
  int lo = (int)lo64;
  int count = (int)(end - lo64);
  count = count < 0 ? 0 : count;
  const long long q = queries[i];
  for (int s = 0; s < steps; ++s) {
    const int step = count >> 1;  // floor division, as the plain version
    const int idx = lo + step;
    int c = idx < 0 ? 0 : idx;
    c = c > n32 - 1 ? n32 - 1 : c;
    const long long probe = __ldg(data + c);
    const bool right = (probe < q) && (idx < n32);
    lo = right ? lo + step + 1 : lo;
    count = right ? count - step - 1 : step;
  }
  out[i] = lo;
}

template <typename LoT>
int launch(const void* data, long long n, const void* queries, const void* lo,
           void* out, long long m, long long max_width, int steps,
           void* stream) {
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  bounded_search_kernel<LoT><<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      (const long long*)data, n, (const long long*)queries,
      (const LoT*)lo, (int*)out, m, max_width, steps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lo as int32 (RMI's fused bounds) or int64 (a plan's generic bounds).
int bounded_search_i32(const void* data, long long n, const void* queries,
                       const void* lo, void* out, long long m,
                       long long max_width, int steps, void* stream) {
  return launch<int>(data, n, queries, lo, out, m, max_width, steps, stream);
}

int bounded_search_i64(const void* data, long long n, const void* queries,
                       const void* lo, void* out, long long m,
                       long long max_width, int steps, void* stream) {
  return launch<long long>(data, n, queries, lo, out, m, max_width, steps,
                           stream);
}

}  // extern "C"
