// Best categorical split of every feature of a block of LBP codes, for the
// GAB, LB, DAB and RAB trainers.
//
// Replaces cascadeclassifier_tpu/train/boost.py:146 _categorical_split_block
// (regression: GAB, LB) and :274 _categorical_class_split_block (two-class:
// DAB with the misclassification criterion, RAB with Gini), both XLA: a
// jax.lax.scan over the 256 categories, each step a masked row sum of the
// per-sample tables; a stable argsort of the 256 bins; two cumsums; the
// quality; a first argmax; the subset scattered back to category ids. Output
// per feature: the best quality (f64, -inf when no split is valid) and the
// subset, 8 words of 32 bits (bit c & 31 of word c >> 5: category c goes left).
//
// The f64 adds are those of XLA:CPU for the JAX package's program (the
// trainer is held to it bit for bit; train/cat_split.py is the plain
// version):
// - a bin is jnp.sum of a masked row, which XLA:CPU adds as a tree of
//   windows of 32: the row is padded with zeros to a multiple of 32, half of
//   the padding in front, each window summed sequentially from +0.0, the
//   window totals summed the same way, until at most 32 are left, which are
//   summed sequentially. Adding a zero changes nothing, so each bin adds its
//   own samples only, in that grouping;
// - the totals over the 256 bins are the same tree (8 windows, then 8);
// - the prefix sums over the sorted bins are jnp.cumsum's: sequential within
//   blocks of 16 from +0.0, each plus the sequential prefix of the block
//   totals before it;
// - LLVM contracts the quality into fmas: fma(rr^2, lw, lr^2 rw) / (lw rw),
//   and for Gini fma(fma(l0, l0, l1^2), rw, fma(r0, r0, r1^2) lw) / (lw rw).
// --fmad=false keeps every other product and sum rounded on its own.
//
// Bound: the codes (4 B a sample and feature) read once; the histogram's
// compares and adds are far below it at f64 rates.
//
// Design (simple first): a CTA of 256 threads, one a category, walks its
// features persistently. The per-sample tables go to shared memory once a
// CTA when they fit (else they are read from global memory, where they stay
// in L2). A feature's codes are staged through shared memory in chunks;
// every thread reads each code (a broadcast) and adds the tables of the
// samples of its own category into its tree of windows, so no two threads
// add to one sum and no atomics are needed. Then, in shared memory: a
// bitonic sort of (key, category) pairs (lexicographic, so ties keep category
// order, as the stable sort does), the two blocked prefix scans, the quality
// at each sorted position, the first maximum by shuffles, and the subset
// words by ballots.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kCats = 256;             // LBP codes: one thread a category
constexpr int kThreads = kCats;
constexpr int kWindow = 32;            // XLA:CPU TreeReductionRewriter window
constexpr int kBase = 16;              // XLA:CPU ReduceWindowRewriter base length
constexpr int kMaxLevels = 4;          // tree levels over the samples: 32^5 samples
constexpr int kChunk = 4096;           // codes staged at a time
constexpr double kFltEps = 1.1920928955078125e-07;
constexpr double kDblEps = 2.220446049250313e-16;
constexpr unsigned kFull = 0xffffffffu;

enum Policy { kReg = 0, kMisclass = 1, kGini = 2 };

// The tree of windows over n samples: levels with padding (a level of more
// than 32 items), the padding in front of each and its item count; the top
// level (at most 32 items) is one sequential run.
struct Tree {
  int levels;
  int lo[kMaxLevels + 1];
  int len[kMaxLevels + 1];
};

struct Args {
  const int* codes;  // (b, n) int32, row-major
  const double* t0;  // per-sample tables, n each
  const double* t1;
  int n, b, policy;
  bool stage_tables;
  Tree tree;
  double* q_out;
  int* subset_out;  // (b, 8)
};

// The per-phase arrays of a feature, after the staged codes (and tables).
struct Work {
  double h0[kCats], h1[kCats];  // the bins, by category
  double key[kCats];            // the sort keys, then sorted
  double x0[kCats], x1[kCats];  // the sorted values scanned, then their prefixes
  double win0[kCats / kWindow], win1[kCats / kWindow];
  double rq[kThreads / 32];
  int rpos[kThreads / 32];
  int idx[kCats];  // the category at each sorted position
  int flag[kCats];
};

// Closes an item of value (v0, v1) at level 1 and carries closed windows up;
// a[l], cnt[l]: the open window's sum and the items seen at level l.
__device__ __forceinline__ void push_up(double* a0, double* a1, int* cnt, const Tree& t,
                                        double v0, double v1) {
  bool carry = true;
#pragma unroll
  for (int l = 1; l <= kMaxLevels; ++l) {
    if (carry && l <= t.levels) {
      if (l == t.levels) {  // the top: one sequential run from +0.0
        a0[l] = __dadd_rn(a0[l], v0);
        a1[l] = __dadd_rn(a1[l], v1);
        carry = false;
      } else {
        const int p = t.lo[l] + cnt[l];  // its position in the padded level
        const bool start = (p & (kWindow - 1)) == 0 || cnt[l] == 0;
        a0[l] = __dadd_rn(start ? 0.0 : a0[l], v0);
        a1[l] = __dadd_rn(start ? 0.0 : a1[l], v1);
        ++cnt[l];
        carry = (p & (kWindow - 1)) == kWindow - 1 || cnt[l] == t.len[l];
        v0 = a0[l];
        v1 = a1[l];
      }
    }
  }
}

// The higher quality wins, the lower position wins a tie: the first maximum.
__device__ __forceinline__ void take(double& q, int& pos, double oq, int op) {
  if (oq > q || (oq == q && op < pos)) {
    q = oq;
    pos = op;
  }
}

__global__ void __launch_bounds__(kThreads) cat_split_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int c = threadIdx.x;  // the category of the histogram; the sorted position after it
  const int n = a.n;
  int* scodes = reinterpret_cast<int*>(smem);
  Work& wk = *reinterpret_cast<Work*>(smem + kChunk * sizeof(int));
  const double* t0 = a.t0;
  const double* t1 = a.t1;
  if (a.stage_tables) {
    double* s0 = reinterpret_cast<double*>(smem + kChunk * sizeof(int) + sizeof(Work));
    double* s1 = s0 + n;
    for (int j = c; j < n; j += kThreads) {
      s0[j] = a.t0[j];
      s1[j] = a.t1[j];
    }
    t0 = s0;
    t1 = s1;
  }
  const Tree& tr = a.tree;

  for (int f = blockIdx.x; f < a.b; f += gridDim.x) {
    const int* row = a.codes + static_cast<long long>(f) * n;
    // the histogram of category c: level 0 is the samples
    double a0[kMaxLevels + 1], a1[kMaxLevels + 1];
    int cnt[kMaxLevels + 1];
#pragma unroll
    for (int l = 0; l <= kMaxLevels; ++l) {
      a0[l] = a1[l] = 0.0;
      cnt[l] = 0;
    }
    for (int i0 = 0; i0 < n; i0 += kChunk) {
      const int m = min(kChunk, n - i0);
      __syncthreads();  // the previous chunk (or feature) is done
      for (int j = c; j < m; j += kThreads) scodes[j] = __ldg(row + i0 + j);
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const int i = i0 + j;
        const int p = tr.lo[0] + i;
        if ((p & (kWindow - 1)) == 0 || i == 0) {
          a0[0] = 0.0;
          a1[0] = 0.0;
        }
        if (scodes[j] == c) {
          a0[0] = __dadd_rn(a0[0], t0[i]);
          a1[0] = __dadd_rn(a1[0], t1[i]);
        }
        if (tr.levels > 0 && ((p & (kWindow - 1)) == kWindow - 1 || i == n - 1))
          push_up(a0, a1, cnt, tr, a0[0], a1[0]);
      }
    }
    double h0 = a0[0], h1 = a1[0];
#pragma unroll
    for (int l = 1; l <= kMaxLevels; ++l) {
      if (l == tr.levels) {
        h0 = a0[l];
        h1 = a1[l];
      }
    }
    wk.h0[c] = h0;
    wk.h1[c] = h1;
    // regression: sort by mean response; two-class: by the class-1 weight
    double key = h1;
    if (a.policy == kReg) key = fabs(h0) > kDblEps ? __ddiv_rn(h1, h0) : 0.0;
    wk.key[c] = key;
    wk.idx[c] = c;
    __syncthreads();
    // the totals over the bins, in category order: windows of 32, then 8
    if (c < kCats / kWindow) {
      double s0 = 0.0, s1 = 0.0;
      for (int j = 0; j < kWindow; ++j) {
        s0 = __dadd_rn(s0, wk.h0[c * kWindow + j]);
        s1 = __dadd_rn(s1, wk.h1[c * kWindow + j]);
      }
      wk.win0[c] = s0;
      wk.win1[c] = s1;
    }
    // bitonic sort of (key, category), ascending
    for (int k = 2; k <= kCats; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        __syncthreads();
        const int o = c ^ j;
        if (o > c) {
          const double ka = wk.key[c], kb = wk.key[o];
          const int ia = wk.idx[c], ib = wk.idx[o];
          const bool after = ka > kb || (ka == kb && ia > ib);
          if (after == ((c & k) == 0)) {
            wk.key[c] = kb;
            wk.key[o] = ka;
            wk.idx[c] = ib;
            wk.idx[o] = ia;
          }
        }
      }
    }
    __syncthreads();
    double tot0 = 0.0, tot1 = 0.0;
#pragma unroll
    for (int w = 0; w < kCats / kWindow; ++w) {
      tot0 = __dadd_rn(tot0, wk.win0[w]);
      tot1 = __dadd_rn(tot1, wk.win1[w]);
    }
    // position c of the sorted order
    const int cat = wk.idx[c];
    const double s0 = wk.h0[cat], s1 = wk.h1[cat];
    bool skip = false;
    double x0, x1;
    if (a.policy == kReg) {
      x0 = s0;                          // cnt_s
      x1 = __dmul_rn(wk.key[c], s0);    // means * cnts
    } else {
      skip = __dadd_rn(s0, s1) < kFltEps;  // skipped categories move no mass
      x0 = skip ? 0.0 : s0;
      x1 = skip ? 0.0 : s1;
    }
    const int blk = c / kBase, lane = c % kBase;
    // within the block of 16: the sequential prefix from +0.0
    __syncthreads();  // the sort's keys are read
    wk.x0[c] = x0;
    wk.x1[c] = x1;
    __syncthreads();
    double p0 = 0.0, p1 = 0.0;
    for (int j = 0; j <= lane; ++j) {
      p0 = __dadd_rn(p0, wk.x0[blk * kBase + j]);
      p1 = __dadd_rn(p1, wk.x1[blk * kBase + j]);
    }
    __syncthreads();
    wk.x0[c] = p0;
    wk.x1[c] = p1;
    __syncthreads();
    // plus the sequential prefix of the block totals before this block
    double e0 = 0.0, e1 = 0.0;
    for (int k = 0; k < blk; ++k) {
      e0 = __dadd_rn(e0, wk.x0[k * kBase + kBase - 1]);
      e1 = __dadd_rn(e1, wk.x1[k * kBase + kBase - 1]);
    }
    const double l0 = __dadd_rn(p0, e0), l1 = __dadd_rn(p1, e1);
    const double r0 = __dsub_rn(tot0, l0), r1 = __dsub_rn(tot1, l1);
    double q;
    bool ok;
    if (a.policy == kReg) {  // l0, l1, r0, r1: lw, lr, rw, rr
      ok = s0 > kFltEps && l0 > kFltEps && r0 > kFltEps && c < kCats - 1;
      const double num = __fma_rn(__dmul_rn(r1, r1), l0, __dmul_rn(__dmul_rn(l1, l1), r0));
      q = __ddiv_rn(ok ? num : 0.0, ok ? __dmul_rn(l0, r0) : 1.0);
    } else if (a.policy == kGini) {
      const double lw = __dadd_rn(l0, l1), rw = __dadd_rn(r0, r1);
      ok = !skip && c < kCats - 1 && lw > kFltEps && rw > kFltEps;
      const double num = __fma_rn(__fma_rn(l0, l0, __dmul_rn(l1, l1)), rw,
                                  __dmul_rn(__fma_rn(r0, r0, __dmul_rn(r1, r1)), lw));
      q = __ddiv_rn(ok ? num : 0.0, ok ? __dmul_rn(lw, rw) : 1.0);
    } else {
      ok = !skip && c < kCats - 1;
      q = fmax(__dadd_rn(l0, r1), __dadd_rn(l1, r0));
    }
    q = ok ? q : -CUDART_INF;
    // the first maximum: within each warp by shuffles, then across the warps
    int pos = c;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const double oq = __shfl_xor_sync(kFull, q, off);
      const int op = __shfl_xor_sync(kFull, pos, off);
      take(q, pos, oq, op);
    }
    if ((c & 31) == 0) {
      wk.rq[c >> 5] = q;
      wk.rpos[c >> 5] = pos;
    }
    __syncthreads();
    double bq = wk.rq[0];
    int best = wk.rpos[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) take(bq, best, wk.rq[w], wk.rpos[w]);
    // the categories at sorted positions up to the best go left
    wk.flag[cat] = c <= best;
    __syncthreads();
    const unsigned word = __ballot_sync(kFull, wk.flag[c] != 0);
    if ((c & 31) == 0) a.subset_out[static_cast<long long>(f) * (kCats / 32) + (c >> 5)] =
        static_cast<int>(word);
    if (c == 0) a.q_out[f] = bq;
  }
}

}  // namespace

// codes (n, b as (b, n) int32 row-major, values in [0, 256)), the per-sample
// tables t0, t1 (f64, n each: masked weights and weight x responses for
// policy 0, the masked weights of class 0 and of class 1 for policies 1
// (misclassification) and 2 (Gini)) → q (b,) f64 and subset (b, 8) int32.
// Returns cudaGetLastError() after the launch.
extern "C" int cct_cat_split(const void* codes, const void* t0, const void* t1, int n, int b,
                             int policy, void* q, void* subset, void* stream) {
  if (n <= 0 || b < 0 || policy < kReg || policy > kGini)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaGetLastError());
  Args a{};
  a.codes = static_cast<const int*>(codes);
  a.t0 = static_cast<const double*>(t0);
  a.t1 = static_cast<const double*>(t1);
  a.n = n;
  a.b = b;
  a.policy = policy;
  a.q_out = static_cast<double*>(q);
  a.subset_out = static_cast<int*>(subset);
  // the tree of windows over the samples (train/cat_split.py::histograms)
  Tree& t = a.tree;
  t.levels = 0;
  t.len[0] = n;
  t.lo[0] = 0;
  while (t.len[t.levels] > kWindow) {
    if (t.levels == kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
    const int len = t.len[t.levels];
    const int padded = (len + kWindow - 1) / kWindow * kWindow;
    t.lo[t.levels] = (padded - len) / 2;
    ++t.levels;
    t.len[t.levels] = padded / kWindow;
    t.lo[t.levels] = 0;
  }
  int dev = 0, optin = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t base = kChunk * sizeof(int) + sizeof(Work);
  const size_t tables = 2 * sizeof(double) * static_cast<size_t>(n);
  a.stage_tables = base + tables <= static_cast<size_t>(optin);
  const size_t smem = base + (a.stage_tables ? tables : 0);
  cudaError_t err = cudaFuncSetAttribute(cat_split_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cat_split_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = b < sms * per_sm ? b : sms * per_sm;
  cat_split_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
