// f32 two-stage RMI lookups for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmi_lookup/kernel.py::
// rmi_infer_kernel together with the jnp around it in ops.py::rmi_bounds
// (stage-1 inference, bucket select, clamp, floor/ceil, clip), and, in the
// fused entry, ops.py::rmi_lookup's bounded last mile as well.  Per query:
//   u    = (f32(hi)*2^32 + f32(lo) - x0) * inv_range
//   bkt  = clip(floor((c0*u + c1) * scale), 0, B-1)
//   pred = clip(a2[bkt]*u + b2[bkt], -1, f32(n+1))
//   lo   = clip(floor(pred) - err[bkt], 0, n)
//   hi   = clip(ceil(pred) + err[bkt], 0, n)
// with the arithmetic of lookup.cuh (_rn intrinsics, no FMA).
//
// Two entries:
//   rmi_bounds  queries -> (lo, hi), the counterpart of rmi_infer_kernel;
//   rmi_lookup  queries -> int64 LB rank in one launch: the bounds stay in
//               registers and feed B1's search (lookup.cuh) over the
//               query's own window, as bounded_search.cu does.
//
// What bounds it on this card: rmi_bounds by bytes (8 in, 8 out a query,
// and three random 32-byte L2 sectors of the table); rmi_lookup by the
// search's distinct sectors, as B1 (lookup.cuh says how that was found).
//
// What the design does about it: the stage-2 tables (a2, b2, err; 3 MB at
// 2^18 buckets) stay resident in the 50 MB L2, so a query's three gathers
// are L2 hits.  A packed 16-byte record a bucket, read with one load, was
// timed on the H100 and did not pay (PERF.md).  The fused search starts at
// the window's midpoint, which is the RMI's own prediction (its window is
// floor(pred) - err .. ceil(pred) + err), and walks out one sector further
// than B1 does (kNearBlocks = 1: the midpoint, the edge of its sector, then
// the next sector) before the balanced search: most answers lie within a
// few keys of the prediction (on wiki a median 5, nine in ten within 12),
// so most queries touch one or two sectors instead of a balanced search's
// three or more.  B1 stops at the midpoint's own sector because its windows
// come from every family, and on PGM's, RadixSpline's and RBS's the extra
// sector read more than it saved (PERF.md).  The TPU sorted queries
// by bucket and prefetched two 2048-row table tiles per 1024-query block
// because its per-query HBM gathers are slow and its table could not sit in
// VMEM; here no sort, no unsort, no tile fallback.  The fused entry writes
// no lo or hi to device memory and writes the rank as the int64 the plan
// returns.
#include "lookup.cuh"

namespace {

constexpr int kThreads = 256;
// How far the fused search walks out from the window's midpoint, the RMI's
// prediction (lookup.cuh's window_lower_bound): one sector past its own.
constexpr int kNearBlocks = 1;

__global__ void __launch_bounds__(kThreads)
    rmi_bounds_kernel(const long long* __restrict__ queries, long long m,
                      lookup::RmiModel model, const float* __restrict__ a2,
                      const float* __restrict__ b2,
                      const int* __restrict__ err, int* __restrict__ lo_out, int* __restrict__ hi_out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  int lo, hi;
  lookup::rmi_bounds_one(model, a2, b2, err, queries[i], lo, hi);
  lo_out[i] = lo;
  hi_out[i] = hi;
}

__global__ void __launch_bounds__(kThreads)
    rmi_lookup_kernel(const long long* __restrict__ queries, long long m,
                      lookup::RmiModel model, const float* __restrict__ a2,
                      const float* __restrict__ b2,
                      const int* __restrict__ err,
                      const long long* __restrict__ data, long long max_err,
                      long long* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const long long q = queries[i];
  int lo, hi;
  lookup::rmi_bounds_one(model, a2, b2, err, q, lo, hi);
  const lookup::Window w = lookup::clip_window(lo, hi, model.n, max_err);
  out[i] = lookup::window_lower_bound<kNearBlocks>(data, model.n, q, w);
}

lookup::RmiModel make_model(float c0, float c1, float x0, float inv_range,
                            float scale, float hi_clamp, int branching,
                            int n) {
  return {c0, c1, x0, inv_range, scale, hi_clamp, branching, n};
}

unsigned blocks_for(long long m) {
  return (unsigned)((m + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int rmi_bounds(const void* queries, long long m, float c0, float c1, float x0,
               float inv_range, float scale, float hi_clamp, int branching,
               int n, const void* a2, const void* b2, const void* err,
               void* lo_out, void* hi_out, void* stream) {
  rmi_bounds_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)queries, m,
      make_model(c0, c1, x0, inv_range, scale, hi_clamp, branching, n),
      (const float*)a2, (const float*)b2, (const int*)err, (int*)lo_out,
      (int*)hi_out);
  return (int)cudaGetLastError();
}

int rmi_lookup(const void* queries, long long m, float c0, float c1, float x0,
               float inv_range, float scale, float hi_clamp, int branching,
               int n, const void* a2, const void* b2, const void* err,
               const void* data, long long max_err, void* out,
               void* stream) {
  rmi_lookup_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)queries, m,
      make_model(c0, c1, x0, inv_range, scale, hi_clamp, branching, n),
      (const float*)a2, (const float*)b2, (const int*)err, (const long long*)data, max_err, (long long*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
