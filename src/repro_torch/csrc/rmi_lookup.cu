// Fused f32 two-stage RMI inference for Hopper (sm_90a): queries -> (lo, hi).
//
// Replaces the TPU kernel src/repro/kernels/rmi_lookup/kernel.py::
// rmi_infer_kernel together with the jnp around it in ops.py::rmi_bounds
// (stage-1 inference, bucket select, clamp, floor/ceil, clip).  Per query:
//   u    = (f32(hi)*2^32 + f32(lo) - x0) * inv_range
//   bkt  = clip(floor((c0*u + c1) * scale), 0, B-1)
//   pred = clip(a2[bkt]*u + b2[bkt], -1, f32(n+1))
//   lo   = clip(floor(pred) - err[bkt], 0, n),  hi = clip(ceil(pred) + err[bkt], 0, n)
//
// Every product and sum is written with an _rn intrinsic.  nvcc would
// otherwise contract a*u+b into an FMA, and the error table is valid only
// under the arithmetic that verified it: the port's prepare_f32_state
// verifies through separate torch multiplies and adds, which these
// intrinsics reproduce bit for bit.
//
// What bounds it on this card: bytes.  Each query reads 8 bytes and writes
// 4 (lo) or 8 (lo, hi); the table (12 bytes a bucket, 3 MB at 2^18 buckets) is gathered at
// random, so each gather is a 32-byte L2 sector.
//
// What the design does about it: the TPU sorted queries by bucket and
// prefetched two 2048-row table tiles per 1024-query block because its
// per-query HBM gathers are slow and its table could not sit in VMEM.  Here
// the whole table sits in the 50 MB L2, so one thread per query gathers
// from it directly: no sort, no unsort, no tile fallback, one launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void rmi_bounds_kernel(const long long* __restrict__ queries,
                                  long long m, float c0, float c1, float x0,
                                  float inv_range, float scale, float hi_clamp,
                                  int branching, int n,
                                  const float* __restrict__ a2,
                                  const float* __restrict__ b2,
                                  const int* __restrict__ err,
                                  int* __restrict__ lo_out,
                                  int* __restrict__ hi_out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  // codec: flip the sign bit back to the uint64 key, split into halves
  const unsigned long long k =
      (unsigned long long)queries[i] ^ 0x8000000000000000ULL;
  const float qf = __fadd_rn(
      __fmul_rn(__uint2float_rn((unsigned)(k >> 32)), 4294967296.0f),
      __uint2float_rn((unsigned)(k & 0xFFFFFFFFULL)));
  const float u = __fmul_rn(__fsub_rn(qf, x0), inv_range);
  const float p1 = __fadd_rn(__fmul_rn(c0, u), c1);
  float s = floorf(__fmul_rn(p1, scale));
  s = fminf(fmaxf(s, 0.0f), (float)(branching - 1));
  const int bkt = (int)s;
  float pred = __fadd_rn(__fmul_rn(__ldg(a2 + bkt), u), __ldg(b2 + bkt));
  pred = fminf(fmaxf(pred, -1.0f), hi_clamp);  // guard the int32 casts
  const int e = __ldg(err + bkt);
  int lo = (int)floorf(pred) - e;
  lo = lo < 0 ? 0 : (lo > n ? n : lo);
  lo_out[i] = lo;
  // the fused lookup searches [lo, lo + max_err) and never reads hi, so it
  // passes no hi buffer and the kernel writes 4 bytes a query, not 8
  if (hi_out != nullptr) {
    int hi = (int)ceilf(pred) + e;
    hi_out[i] = hi < 0 ? 0 : (hi > n ? n : hi);
  }
}

}  // namespace

extern "C" int rmi_bounds(const void* queries, long long m, float c0, float c1,
                          float x0, float inv_range, float scale,
                          float hi_clamp, int branching, int n, const void* a2,
                          const void* b2, const void* err, void* lo_out,
                          void* hi_out, void* stream) {
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  rmi_bounds_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)queries, m, c0, c1, x0, inv_range, scale, hi_clamp,
      branching, n, (const float*)a2, (const float*)b2, (const int*)err,
      (int*)lo_out, (int*)hi_out);
  return (int)cudaGetLastError();
}
