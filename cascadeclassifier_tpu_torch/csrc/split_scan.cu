// Best stump split of every feature of a sorted block, for the GAB trainer.
//
// Replaces cascadeclassifier_tpu/train/boost.py:74 _ordered_split_sorted
// (XLA: cumsum over the sorted axis, a reversed cummin, the quality and a
// first argmax). Input is sample-major: row i of vs (f32), ws and rs (f64)
// and kept (bytes 0/1) holds every feature's i-th sample in that feature's
// ascending order, so thread f (feature f) reads column f and a warp's
// loads are adjacent. Output per feature: the best quality (f64, -inf when
// no split is valid) and the f32 midpoint threshold.
//
// One thread walks its column in sample order and keeps the f64 prefix
// sums of ws and rs in the order XLA:CPU adds them for jnp.cumsum (the
// JAX package's arithmetic, which the trainer is held to bit for bit):
// sequential runs within blocks of 16, each plus the exclusive prefix of
// the block totals, which are scanned the same way one level up; the top
// level is one sequential run. `levels` (train/split.py::scan_levels)
// is the number of block levels. A parallel scan would reorder the adds.
//
// The next kept value after a position is the value at the next kept
// position (the column is sorted), so a kept position is judged when the
// following kept position is reached; the first maximum is kept with a
// strict compare. --fmad=false keeps every other product and sum rounded
// on its own, as XLA:CPU leaves them.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBase = 16;      // XLA:CPU ReduceWindowRewriter base length
constexpr int kMaxLevels = 5;  // 16^6 samples
constexpr float kTwoFltEps = 2.384185791015625e-07f;  // 2 * FLT_EPSILON

struct Scan {
  double acc[kMaxLevels + 1];  // running sum of the open block at each level
  double ep[kMaxLevels + 2];   // ep[l]: prefix of level-(l-1) blocks before the open one
};

// Adds x (level 0) and returns its inclusive prefix; carries closed blocks
// up. cnt[l] counts the open block's members at level l (shared by w and r).
__device__ __forceinline__ double scan_push(Scan& s, const int* cnt, double x, int levels) {
  s.acc[0] = __dadd_rn(cnt[0] == 0 ? 0.0 : s.acc[0], x);
  const double p = levels == 0 ? s.acc[0] : __dadd_rn(s.acc[0], s.ep[1]);
  bool carry = levels > 0 && cnt[0] == kBase - 1;
  double t = s.acc[0];
#pragma unroll
  for (int l = 1; l <= kMaxLevels; ++l) {
    if (carry && l <= levels) {
      s.acc[l] = __dadd_rn(cnt[l] == 0 ? 0.0 : s.acc[l], t);
      s.ep[l] = l == levels ? s.acc[l] : __dadd_rn(s.acc[l], s.ep[l + 1]);
      t = s.acc[l];
      carry = l < levels && cnt[l] == kBase - 1;
    } else {
      carry = false;
    }
  }
  return p;
}

__device__ __forceinline__ void count_push(int* cnt, int levels) {
  bool carry = true;
#pragma unroll
  for (int l = 0; l <= kMaxLevels; ++l) {
    if (carry && l <= levels) {
      ++cnt[l];
      carry = l < levels && cnt[l] == kBase;
      if (carry) cnt[l] = 0;
    }
  }
}

__global__ void split_scan_kernel(const float* __restrict__ vs, const double* __restrict__ ws,
                                  const double* __restrict__ rs,
                                  const uint8_t* __restrict__ kept, int n, int b, int levels,
                                  double total_w, double total_r, double* __restrict__ q_out,
                                  float* __restrict__ thr_out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= b) return;
  Scan sw, sr;
  int cnt[kMaxLevels + 1];
#pragma unroll
  for (int l = 0; l <= kMaxLevels; ++l) {
    sw.acc[l] = sr.acc[l] = 0.0;
    cnt[l] = 0;
  }
#pragma unroll
  for (int l = 0; l <= kMaxLevels + 1; ++l) sw.ep[l] = sr.ep[l] = 0.0;

  double best_q = -CUDART_INF;
  float best_v = 0.f, best_n = 0.f;
  float first_next = CUDART_INF_F;  // first kept value after position 0
  bool have_prev = false, first_seen = false;
  float prev_v = 0.f;
  double prev_lw = 0.0, prev_lr = 0.0;

  for (int i = 0; i < n; ++i) {
    const size_t k = static_cast<size_t>(i) * b + f;
    const double lw = scan_push(sw, cnt, ws[k], levels);
    const double lr = scan_push(sr, cnt, rs[k], levels);
    count_push(cnt, levels);
    if (!kept[k]) continue;
    const float v = vs[k];
    if (i > 0 && !first_seen) {
      first_next = v;
      first_seen = true;
    }
    if (have_prev) {
      // judge the previous kept position, whose next kept value is v
      const double rw = __dsub_rn(total_w, prev_lw);
      const double rr = __dsub_rn(total_r, prev_lr);
      if (__fadd_rn(prev_v, kTwoFltEps) < v && prev_lw > 0.0 && rw > 0.0) {
        // XLA:CPU contracts lr*lr*rw + rr*rr*lw into one fma: of rr*rr*lw
        // when the scan has block levels, of lr*lr*rw when it has none
        const double a = __dmul_rn(prev_lr, prev_lr), c = __dmul_rn(rr, rr);
        const double num = levels > 0 ? __fma_rn(c, prev_lw, __dmul_rn(a, rw))
                                      : __fma_rn(a, rw, __dmul_rn(c, prev_lw));
        const double q = __ddiv_rn(num, __dmul_rn(prev_lw, rw));
        if (q > best_q) {
          best_q = q;
          best_v = prev_v;
          best_n = v;
        }
      }
    }
    have_prev = true;
    prev_v = v;
    prev_lw = lw;
    prev_lr = lr;
  }
  if (best_q == -CUDART_INF) {  // no valid split: position 0, as the first max of -inf
    best_v = vs[f];
    best_n = first_next;
  }
  q_out[f] = best_q;
  thr_out[f] = __fmul_rn(__fadd_rn(best_v, best_n), 0.5f);
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int cct_split_scan(const void* vs, const void* ws, const void* rs, const void* kept,
                              int n, int b, int levels, double total_w, double total_r,
                              void* q, void* thr, void* stream) {
  if (n <= 0 || b < 0 || levels < 0 || levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaGetLastError());
  split_scan_kernel<<<(b + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vs), static_cast<const double*>(ws),
      static_cast<const double*>(rs), static_cast<const uint8_t*>(kept), n, b, levels, total_w,
      total_r, static_cast<double*>(q), static_cast<float*>(thr));
  return static_cast<int>(cudaGetLastError());
}
