// PGM-index lookups for Hopper (sm_90a): the descent and the last mile in
// one launch.
//
// Replaces no TPU kernel: the reference runs PGM's descent as jnp ops
// (src/repro/core/pgm.py, the build's lookup) before the bounded-search
// kernel.  The port ran the same descent as eager torch ops
// (src/repro_torch/core/pgm.py::descend), some 128 kernels a batch, each
// writing a batch-long f64 or int64 temporary to device memory and reading
// it back, then bounded_search.cu over the windows.  Here each query
// descends in registers.  Per query, with qf = f64(hi)*2^32 + f64(lo) of
// its uint64 key (rounded once):
//   top     seg = clip(#(top anchors <= qf) - 1, 0, n_top - 1)
//   level l (depth-1 .. 1), predicting a segment of level l-1 (m anchors):
//           pred = clip(ay[seg] + sl[seg] * (qf - ax[seg]), -1, m + 1)
//           lo   = clip(floor(pred) - err_l, 0, m - 1)
//           hi   = clip(ceil(pred) + err_l, 0, m - 1)
//           seg  = clip(upper_bound of qf in level l-1's ax[lo..hi] - 1,
//                       0, m - 1)
//   leaf    pred = clip(ay[seg] + sl[seg] * (qf - ax[seg]), -1, n + 1)
//           window clip(floor(pred) - e0, 0, n) .. clip(ceil(pred) + e0, 0, n)
//   then B1's search (lookup.cuh) over the window, clipped by max_err, and
// the rank written as int64.  Every product, sum and difference is an _rn
// intrinsic (no FMA), in the torch ops' order, so the errors the build
// verified through those ops (pgm.py::_level_error) hold here; the
// upper-bound search repeats core/search.py::bounded_binary's fixed trip
// count step for step (floor halving, clamped probe, position m as +inf),
// so a window that misses the answer gives the same index as well.  The
// top level's count is an upper-bound search over its ascending anchors,
// which is the same count.
//
// What bounds it on this card: B1's distinct 32-byte sectors of the sorted
// keys (lookup.cuh says how that was found), plus a few L2 reads a level.
// The index (under 1 MiB on wiki's 200M keys) stays resident in the 50 MB
// L2: a level reads one segment's three f64 values and its search probes a
// window of about 2*err_l + 3 anchors, a few adjacent sectors.
//
// What the design does about it: nothing but the rank goes to device
// memory (no lo, hi or segment arrays); every level, the top one included
// (at most top_cutoff anchors, 64 by default), is read from global memory,
// where a warp's lanes share the few cached lines a level touches (staging
// the top level in shared memory a block measured 2-5% slower on an H100,
// on the wiki cells' 10M batches); the last mile is B1's own loop
// (kNearBlocks = 0: the window's midpoint, then the edge of its sector),
// since the windows are the ones B1 searched before.  The levels arrive
// as one by-value argument of at most kMaxDepth levels.
#include "lookup.cuh"

namespace {

constexpr int kThreads = 256;
// The deepest PGM the kernel descends.  A level of the fit holds at most a
// third of the one below's anchors (a cone of any error >= 1 takes three
// points), so 24 covers every depth the schema can make over n < 2^31.
constexpr int kMaxDepth = 24;
// How far the last mile walks out from its window's midpoint: B1's depth on
// int64 keys (bounded_search.cu).
constexpr int kNearBlocks = 0;
static_assert(kThreads >= kMaxDepth, "a block copies one level a thread");

struct Level {
  const double* ax;  // anchor keys, ascending
  const double* ay;  // intercepts
  const double* sl;  // slopes
  long long m;       // segments
  int err;           // verified error of this level's prediction
  int steps;         // bounded_binary's trip count over its window
};

struct Model {
  Level level[kMaxDepth];  // level 0 (the leaf) first
  int depth;
  long long n;        // keys
  long long e0;       // the leaf window's half-width
  long long max_err;  // the plan's window bound
};

// kernels/common.py::keys_to_f64 of an encoded key.
__device__ __forceinline__ double key_f64(long long q) {
  const unsigned long long k = (unsigned long long)q ^ 0x8000000000000000ULL;
  return __dadd_rn(
      __dmul_rn(__uint2double_rn((unsigned)(k >> 32)), 4294967296.0),
      __uint2double_rn((unsigned)(k & 0xFFFFFFFFULL)));
}

// pgm.py::_seg_pred, then its clamp to [-1, hi_clamp].
__device__ __forceinline__ double seg_pred(const Level& l, long long seg,
                                           double qf, double hi_clamp) {
  const double p =
      __dadd_rn(__ldg(l.ay + seg),
                __dmul_rn(__ldg(l.sl + seg), __dsub_rn(qf, __ldg(l.ax + seg))));
  return fmin(fmax(p, -1.0), hi_clamp);
}

__device__ __forceinline__ long long clip(long long v, long long lo,
                                          long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// search.py::bounded_binary(x, qf, lo, hi, ..., side="right") over x[0..m):
// `steps` halvings of the window [lo, hi], each probe clamped into the array
// and position m comparing as +inf.
__device__ __forceinline__ int bounded_upper(const double* __restrict__ x,
                                             int m, double qf, int lo, int hi,
                                             int steps) {
  int count = hi + 1 - lo;
  count = count < 0 ? 0 : count;
  for (int s = 0; s < steps; ++s) {
    const int step = count >> 1;  // floor division, as torch's //
    const int idx = lo + step;
    const int at = idx < 0 ? 0 : (idx > m - 1 ? m - 1 : idx);
    const bool right = (__ldg(x + at) <= qf) & (idx < m);
    lo = right ? lo + step + 1 : lo;
    count = right ? count - step - 1 : step;
  }
  return lo;
}

// #(top[j] <= qf) over ascending anchors: their upper bound.
__device__ __forceinline__ int top_count(const double* top, int n_top,
                                         double qf) {
  int a = 0, count = n_top;
  while (count > 0) {
    const int half = count >> 1;
    const bool right = top[a + half] <= qf;
    a = right ? a + half + 1 : a;
    count = right ? count - half - 1 : half;
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
    pgm_lookup_kernel(const long long* __restrict__ queries, long long m,
                      const Model model, const long long* __restrict__ data,
                      long long* __restrict__ out) {
  // The levels go to shared memory first, each copied from its constant
  // offset in the argument: the descent indexes them by a variable level,
  // which on the argument itself could make a per-thread local copy.
  __shared__ Level s_level[kMaxDepth];
#pragma unroll
  for (int l = 0; l < kMaxDepth; ++l)
    if (threadIdx.x == l) s_level[l] = model.level[l];
  __syncthreads();
  const int depth = model.depth;
  const int n_top = (int)s_level[depth - 1].m;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const long long q = queries[i];
  const double qf = key_f64(q);
  int seg = (int)clip(top_count(s_level[depth - 1].ax, n_top, qf) - 1, 0,
                      n_top - 1);
  for (int lvl = depth - 1; lvl > 0; --lvl) {
    const Level& l = s_level[lvl];
    const Level& below = s_level[lvl - 1];
    const int mb = (int)below.m;
    const double pred = seg_pred(l, seg, qf, (double)mb + 1.0);
    const int lo = (int)clip((long long)floor(pred) - l.err, 0, mb - 1);
    const int hi = (int)clip((long long)ceil(pred) + l.err, 0, mb - 1);
    const int ub = bounded_upper(below.ax, mb, qf, lo, hi, l.steps);
    seg = (int)clip(ub - 1, 0, mb - 1);
  }
  const long long n = model.n;
  const double pred = seg_pred(s_level[0], seg, qf, (double)n + 1.0);
  const long long lo = clip((long long)floor(pred) - model.e0, 0, n);
  const long long hi = clip((long long)ceil(pred) + model.e0, 0, n);
  const lookup::Window w = lookup::clip_window(lo, hi, n, model.max_err);
  out[i] = lookup::window_lower_bound<kNearBlocks>(data, (int)n, q, w);
}

}  // namespace

// queries and data are encoded int64 keys; model_arg points to the host's
// Model, passed to the kernel by value; out is int64.
extern "C" int pgm_lookup(const void* queries, long long m,
                          const void* model_arg, const void* data, void* out,
                          void* stream) {
  const Model* model = (const Model*)model_arg;
  if (model->depth < 1 || model->depth > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  pgm_lookup_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)queries, m, *model, (const long long*)data,
      (long long*)out);
  return (int)cudaGetLastError();
}
