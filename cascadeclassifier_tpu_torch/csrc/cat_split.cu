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
//   summed sequentially. Adding a zero changes nothing (no sum here is ever
//   -0.0), so each bin adds its own samples only, in that grouping;
// - the totals over the 256 bins are the same tree (8 windows, then 8);
// - the prefix sums over the sorted bins are jnp.cumsum's: sequential within
//   blocks of 16 from +0.0, each plus the sequential prefix of the block
//   totals before it;
// - LLVM contracts the quality into fmas: fma(rr^2, lw, lr^2 rw) / (lw rw),
//   and for Gini fma(fma(l0, l0, l1^2), rw, fma(r0, r0, r1^2) lw) / (lw rw).
// --fmad=false keeps every other product and sum rounded on its own.
//
// Bound: the codes (4 B a sample and feature) read once; the histogram's
// adds are far below it at f64 rates. What costs is issue and latency:
// each window's group sums are chains of shuffles and adds as long as the
// window's largest group, and __match_any_sync takes longer the more
// distinct codes a window holds (utils/tune_cat_split.py).
//
// Design: one warp a feature, kWarps (8) warps a CTA, persistent over the
// features, registers capped for kSmWarps (24) warps an SM; no CTA barrier.
// - Phase 1, the histograms. The warp walks the feature's row in the
//   level-0 windows of 32 padded positions, kDepth (2) at a time: lane k
//   loads sample 32 w - lo[0] + k (a coalesced 128 B read) and its two
//   table values (global memory, where they stay in L1/L2: staging them
//   in shared memory costs occupancy and was slower), the next windows'
//   loads issued before this pair's leaders add. __match_any_sync groups
//   the lanes of equal codes; every lane sums its group's values in lane
//   (= sample) order from +0.0 by shuffles, the lowest lane left first
//   (the leading zeros of the bit-reversed mask), which is exactly the
//   window's sum for that category; the windows' chains interleave. The group's first lane adds
//   the sum into the category's level-1 accumulator (a per-warp array of
//   256 f64 pairs in shared memory; categories are distinct across
//   leaders, so no atomics). Lanes past the row take code -1, no category.
// - The upper levels, per lane. A level-1 window closes where
//   (lo[1] + w) mod 32 == 31 or at the last window w: then each lane takes
//   its 8 categories (lane + 32 j) out of the accumulator, resets it, and
//   carries them up the remaining levels as XLA:CPU's tree does (one
//   accumulator a level in the warp's shared memory; the top level, at
//   most 32 items, one sequential run). With one level (n <= 1024) the
//   level-1 accumulator is the top; with none (n <= 32) it takes the one
//   window's totals.
// - Phase 2, inside the warp: the 256 (key, category) rows, 8 a lane at
//   sorted positions 8 lane + r, bitonic-sorted by register swaps and
//   shuffles (lexicographic, so ties keep category order, as the stable
//   sort does); the totals over the bins (8 lanes, a window of 32 each);
//   the blocked prefix scans (a block of 16 is 2 lanes); the quality at
//   each position; the first maximum by shuffles; the subset words by
//   ballots over a per-warp flag array.
//
// utils/tune_cat_split.py times other geometries and ablations of this
// source (text substitutions in a copy).

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kCats = 256;             // LBP codes
constexpr int kPerLane = kCats / 32;   // categories (then sorted positions) a lane
constexpr int kWindow = 32;            // XLA:CPU TreeReductionRewriter window
constexpr int kBase = 16;              // XLA:CPU ReduceWindowRewriter base length
constexpr int kMaxLevels = 4;          // tree levels over the samples: 32^5 samples
constexpr int kWarps = 8;              // warps a CTA, each its own features
constexpr int kDepth = 2;              // windows taken at a time
constexpr int kSmWarps = 24;           // warps an SM the registers are capped for
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
  int nacc;  // accumulator levels a warp keeps: max(levels, 1)
  Tree tree;
  double* q_out;
  int* subset_out;  // (b, 8)
};

// Doubles of a warp's shared memory: nacc levels of 256 (table 0, table 1)
// pairs, then 256 flag bytes.
__host__ __device__ constexpr int warp_doubles(int nacc) { return nacc * 2 * kCats + kCats / 8; }

// Carries the closed level-1 windows of this lane's categories (lane + 32 j)
// up the tree from level 2; acc holds the levels' open windows (level l at
// (l - 1) * kCats), cnt[l] the items seen at level l (the same for every
// category).
__device__ __forceinline__ void fold(double2* acc, int lane, int* cnt, const Tree& t) {
  double2 v[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    v[j] = acc[lane + 32 * j];
    acc[lane + 32 * j] = make_double2(0.0, 0.0);
  }
#pragma unroll
  for (int l = 2; l <= kMaxLevels; ++l) {
    if (l > t.levels) break;
    double2* al = acc + (l - 1) * kCats + lane;
    if (l == t.levels) {  // the top: one sequential run from +0.0
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const double2 o = al[32 * j];
        al[32 * j] = make_double2(__dadd_rn(o.x, v[j].x), __dadd_rn(o.y, v[j].y));
      }
      break;
    }
    const int p = t.lo[l] + cnt[l];  // the item's position in the padded level
    const bool start = (p & (kWindow - 1)) == 0 || cnt[l] == 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const double2 o = start ? make_double2(0.0, 0.0) : al[32 * j];
      v[j] = make_double2(__dadd_rn(o.x, v[j].x), __dadd_rn(o.y, v[j].y));
      al[32 * j] = v[j];
    }
    ++cnt[l];
    if ((p & (kWindow - 1)) != kWindow - 1 && cnt[l] != t.len[l]) break;
  }
}

// The higher quality wins, the lower position wins a tie: the first maximum.
__device__ __forceinline__ void take(double& q, int& pos, double oq, int op) {
  if (oq > q || (oq == q && op < pos)) {
    q = oq;
    pos = op;
  }
}

// (ka, ia) sorts after (kb, ib): ascending keys, ties in category order.
__device__ __forceinline__ bool after(double ka, int ia, double kb, int ib) {
  return ka > kb || (ka == kb && ia > ib);
}

__global__ void __launch_bounds__(kWarps * 32, kSmWarps / kWarps) cat_split_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int n = a.n;
  const Tree& tr = a.tree;
  const double* t0 = a.t0;
  const double* t1 = a.t1;
  double* base = reinterpret_cast<double*>(smem);
  double2* acc = reinterpret_cast<double2*>(base + (threadIdx.x >> 5) * warp_doubles(a.nacc));
  uint8_t* flag = reinterpret_cast<uint8_t*>(acc + a.nacc * kCats);
  const double2* h = acc + (a.nacc - 1) * kCats;  // the bins: the top level
  const int nw = tr.levels > 0 ? tr.len[1] : 1;  // level-0 windows
  const int lo0 = tr.lo[0];

  for (int f = blockIdx.x * kWarps + (threadIdx.x >> 5); f < a.b; f += gridDim.x * kWarps) {
    const int* row = a.codes + static_cast<long long>(f) * n;
    for (int k = lane; k < a.nacc * kCats; k += 32) acc[k] = make_double2(0.0, 0.0);
    int cnt[kMaxLevels + 1];
#pragma unroll
    for (int l = 0; l <= kMaxLevels; ++l) cnt[l] = 0;
    __syncwarp();

    // ---- phase 1: the histograms, kDepth windows at a time
    int code[kDepth];
    double x0[kDepth], x1[kDepth];
    auto load = [&](int d, int w) {
      const int i = w * kWindow - lo0 + lane;
      const bool in = w < nw && i >= 0 && i < n;
      code[d] = in ? __ldg(row + i) : -1;  // no category
      x0[d] = in ? __ldg(t0 + i) : 0.0;
      x1[d] = in ? __ldg(t1 + i) : 0.0;
    };
#pragma unroll
    for (int d = 0; d < kDepth; ++d) load(d, d);
    for (int w0 = 0; w0 < nw; w0 += kDepth) {
      // each window's groups of equal codes, summed in lane order from
      // +0.0: the window's sum of that category (its a0 in the tree); the
      // windows' chains interleave. rest: the members still to add, bit
      // reversed, so that the lowest lane left is its leading zeros
      int cd[kDepth];
      unsigned rest[kDepth], g = 0;
      bool lead[kDepth];
      double2 s[kDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        cd[d] = code[d];
        const bool valid = static_cast<unsigned>(cd[d]) < kCats;
        const unsigned m = __match_any_sync(kFull, cd[d]);  // the lanes of this code
        rest[d] = valid ? __brev(m) : 0u;
        lead[d] = valid && __ffs(m) - 1 == lane;
        g = max(g, static_cast<unsigned>(__popc(rest[d])));
        s[d] = make_double2(0.0, 0.0);
      }
      g = __reduce_max_sync(kFull, g);
      for (unsigned k = 0; k < g; ++k) {
#pragma unroll
        for (int d = 0; d < kDepth; ++d) {
          const int src = __clz(rest[d]);  // 32 (lane 0, unused) when none is left
          const double v0 = __shfl_sync(kFull, x0[d], src);
          const double v1 = __shfl_sync(kFull, x1[d], src);
          if (rest[d]) {
            s[d] = make_double2(__dadd_rn(s[d].x, v0), __dadd_rn(s[d].y, v1));
            rest[d] ^= 0x80000000u >> src;
          }
        }
      }
      // the next windows' loads go out before the leaders' adds
#pragma unroll
      for (int d = 0; d < kDepth; ++d) load(d, w0 + kDepth + d);
      // the groups' first lanes add their sums into the level-1
      // accumulator, window by window; a closed level-1 window goes up
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int w = w0 + d;
        if (w >= nw) break;
        if (lead[d]) {
          const double2 o = acc[cd[d]];
          acc[cd[d]] = make_double2(__dadd_rn(o.x, s[d].x), __dadd_rn(o.y, s[d].y));
        }
        __syncwarp();  // the leaders' adds are seen by the next window's
        if (tr.levels > 1 && (((tr.lo[1] + w) & (kWindow - 1)) == kWindow - 1 || w == nw - 1)) {
          fold(acc, lane, cnt, tr);
          __syncwarp();
        }
      }
    }

    // ---- phase 2: sort, scans, quality, subset
    // the totals over the bins, in category order: windows of 32, then 8
    double2 win = make_double2(0.0, 0.0);
    if (lane < kCats / kWindow) {
      for (int j = 0; j < kWindow; ++j) {
        const double2 v = h[lane * kWindow + j];
        win = make_double2(__dadd_rn(win.x, v.x), __dadd_rn(win.y, v.y));
      }
    }
    double tot0 = 0.0, tot1 = 0.0;
#pragma unroll
    for (int k = 0; k < kCats / kWindow; ++k) {
      tot0 = __dadd_rn(tot0, __shfl_sync(kFull, win.x, k));
      tot1 = __dadd_rn(tot1, __shfl_sync(kFull, win.y, k));
    }
    // rows (key, category): any placement sorts to the same order; category
    // lane + 32 r starts at position 8 lane + r
    double key[kPerLane];
    int idx[kPerLane];
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      const int c = lane + 32 * r;
      const double2 v = h[c];
      // regression: sort by mean response; two-class: by the class-1 weight
      key[r] = a.policy == kReg ? (fabs(v.x) > kDblEps ? __ddiv_rn(v.y, v.x) : 0.0) : v.y;
      idx[r] = c;
    }
    // bitonic sort, ascending, of position e = 8 lane + r
#pragma unroll
    for (int k = 2; k <= kCats; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        if (j >= kPerLane) {  // the partner is in lane ^ (j / 8), same r
          const int lj = j / kPerLane;
          const bool lower = (lane & lj) == 0;
#pragma unroll
          for (int r = 0; r < kPerLane; ++r) {
            const bool up = ((lane * kPerLane + r) & k) == 0;
            const double ok = __shfl_xor_sync(kFull, key[r], lj);
            const int oi = __shfl_xor_sync(kFull, idx[r], lj);
            const bool mine_after = after(key[r], idx[r], ok, oi);
            if (lower == up ? mine_after : !mine_after) {
              key[r] = ok;
              idx[r] = oi;
            }
          }
        } else {  // within the lane: r and r | j
#pragma unroll
          for (int r = 0; r < kPerLane; ++r) {
            if (r & j) continue;
            const int s = r | j;
            const bool up = ((lane * kPerLane + r) & k) == 0;
            if (after(key[r], idx[r], key[s], idx[s]) == up) {
              const double tk = key[r];
              key[r] = key[s];
              key[s] = tk;
              const int ti = idx[r];
              idx[r] = idx[s];
              idx[s] = ti;
            }
          }
        }
      }
    }
    // the sorted values to scan; okb: regression cnt_s > eps, two-class
    // not skipped
    double p0[kPerLane], p1[kPerLane];
    unsigned okb = 0;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      const double2 v = h[idx[r]];
      if (a.policy == kReg) {
        p0[r] = v.x;                       // cnt_s
        p1[r] = __dmul_rn(key[r], v.x);    // means * cnts
        okb |= static_cast<unsigned>(v.x > kFltEps) << r;
      } else {
        const bool skip = __dadd_rn(v.x, v.y) < kFltEps;  // skipped categories move no mass
        p0[r] = skip ? 0.0 : v.x;
        p1[r] = skip ? 0.0 : v.y;
        okb |= static_cast<unsigned>(!skip) << r;
      }
    }
    // within the block of 16 (lanes 2 b and 2 b + 1): the sequential prefix
    // from +0.0, an odd lane going on from its even neighbour's total
    double c0 = 0.0, c1 = 0.0;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      c0 = __dadd_rn(c0, p0[r]);
      c1 = __dadd_rn(c1, p1[r]);
    }
    c0 = __shfl_up_sync(kFull, c0, 1);
    c1 = __shfl_up_sync(kFull, c1, 1);
    c0 = lane & 1 ? c0 : 0.0;
    c1 = lane & 1 ? c1 : 0.0;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      p0[r] = c0 = __dadd_rn(c0, p0[r]);
      p1[r] = c1 = __dadd_rn(c1, p1[r]);
    }
    // plus the sequential prefix of the block totals before this block
    const int blk = lane >> 1;
    double e0 = 0.0, e1 = 0.0;
#pragma unroll
    for (int k = 0; k < kCats / kBase - 1; ++k) {
      const double v0 = __shfl_sync(kFull, c0, 2 * k + 1);
      const double v1 = __shfl_sync(kFull, c1, 2 * k + 1);
      if (k < blk) {
        e0 = __dadd_rn(e0, v0);
        e1 = __dadd_rn(e1, v1);
      }
    }
    double bq = -CUDART_INF;
    int best = kCats;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      const int e = lane * kPerLane + r;
      const double l0 = __dadd_rn(p0[r], e0), l1 = __dadd_rn(p1[r], e1);
      const double r0 = __dsub_rn(tot0, l0), r1 = __dsub_rn(tot1, l1);
      const bool own = (okb >> r) & 1u;
      double q;
      bool ok;
      if (a.policy == kReg) {  // l0, l1, r0, r1: lw, lr, rw, rr
        ok = own && l0 > kFltEps && r0 > kFltEps && e < kCats - 1;
        const double num = __fma_rn(__dmul_rn(r1, r1), l0, __dmul_rn(__dmul_rn(l1, l1), r0));
        q = __ddiv_rn(ok ? num : 0.0, ok ? __dmul_rn(l0, r0) : 1.0);
      } else if (a.policy == kGini) {
        const double lw = __dadd_rn(l0, l1), rw = __dadd_rn(r0, r1);
        ok = own && e < kCats - 1 && lw > kFltEps && rw > kFltEps;
        const double num = __fma_rn(__fma_rn(l0, l0, __dmul_rn(l1, l1)), rw,
                                    __dmul_rn(__fma_rn(r0, r0, __dmul_rn(r1, r1)), lw));
        q = __ddiv_rn(ok ? num : 0.0, ok ? __dmul_rn(lw, rw) : 1.0);
      } else {
        ok = own && e < kCats - 1;
        q = fmax(__dadd_rn(l0, r1), __dadd_rn(l1, r0));
      }
      take(bq, best, ok ? q : -CUDART_INF, e);
    }
    // the first maximum over the warp
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const double oq = __shfl_xor_sync(kFull, bq, off);
      const int op = __shfl_xor_sync(kFull, best, off);
      take(bq, best, oq, op);
    }
    // the categories at sorted positions up to the best go left
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) flag[idx[r]] = lane * kPerLane + r <= best;
    __syncwarp();
    unsigned mine = 0;
#pragma unroll
    for (int w = 0; w < kCats / 32; ++w) {
      const unsigned word = __ballot_sync(kFull, flag[32 * w + lane] != 0);
      if (lane == w) mine = word;
    }
    if (lane < kCats / 32)
      a.subset_out[static_cast<long long>(f) * (kCats / 32) + lane] = static_cast<int>(mine);
    if (lane == 0) a.q_out[f] = bq;
    __syncwarp();  // the bins and flags are read before the next feature clears them
  }
}

// The tree of windows over n samples (train/cat_split.py::histograms);
// false when it needs more than kMaxLevels levels.
bool make_tree(int n, Tree& t) {
  t.levels = 0;
  t.len[0] = n;
  t.lo[0] = 0;
  while (t.len[t.levels] > kWindow) {
    if (t.levels == kMaxLevels) return false;
    const int len = t.len[t.levels];
    const int padded = (len + kWindow - 1) / kWindow * kWindow;
    t.lo[t.levels] = (padded - len) / 2;
    ++t.levels;
    t.len[t.levels] = padded / kWindow;
    t.lo[t.levels] = 0;
  }
  return true;
}

// The kernel's shared memory for nacc accumulator levels, its CTAs an SM
// and the SMs.
struct Plan {
  size_t smem;
  int per_sm, sms;
};

cudaError_t plan(int nacc, Plan& p) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev);
  p.smem = sizeof(double) * kWarps * static_cast<size_t>(warp_doubles(nacc));
  if (p.smem > static_cast<size_t>(optin)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(cat_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, cat_split_kernel, kWarps * 32,
                                                      p.smem);
  if (err != cudaSuccess) return err;
  return p.per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
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
  if (!make_tree(n, a.tree)) return static_cast<int>(cudaErrorInvalidValue);
  a.nacc = a.tree.levels > 1 ? a.tree.levels : 1;
  Plan p{};
  const cudaError_t err = plan(a.nacc, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (b + kWarps - 1) / kWarps;
  const int grid = ctas < p.sms * p.per_sm ? ctas : p.sms * p.per_sm;
  cat_split_kernel<<<grid, kWarps * 32, p.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The features one launch at n samples works on at once (a warp each: the
// CTAs an SM times the SMs times kWarps) into *slots.
extern "C" int cct_cat_split_slots(int n, int* slots) {
  Tree t{};
  if (n <= 0 || !make_tree(n, t)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  const cudaError_t err = plan(t.levels > 1 ? t.levels : 1, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  *slots = p.sms * p.per_sm * kWarps;
  return 0;
}
