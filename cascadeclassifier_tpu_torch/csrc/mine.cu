// The dense miner: one byte a window, 1 where the current stump cascade
// accepts it, for every window of a superbatch of mining levels, in one
// launch.
//
// Replaces the JAX package's fused dense-mining program,
// cascadeclassifier_tpu/train/predictor.py:518 _dense_chunk_fn (an XLA
// program, not a Pallas kernel): the on-device level build
// (ops/resize.py:151 build_level_stack), the window grid
// (predictor.py:58 _grid_windows), the window integrals
// (ops/integral.py:29, :40, :88), the norm factor (ops/integral.py:199
// window_norm_factor), the corner product or LBP's codes
// (ops/features.py:418 lbp_code_grid) and the f64 stump walk
// (predictor.py:93 _stump_walk). train/mine.py::mine_ref is the plain
// version, built from the port's build_level, haar_rows / lbp_rows,
// integral_tilted, divide_nf and stump_walk.
//
// Input: a level table, one int64 row per run of consecutive windows of a
// level's grid (train/mine.py::pack_levels; columns below, rows in output
// order; the last three columns each row's first tile under each kind's
// tile shape), the lazy levels' sources in one arena and the eager levels'
// images in another (uint8, row-major, at the row's offset), per used
// feature its record (Haar: 3 rects of 4 corner offsets into the window's
// (wh+1) x (ww+1) integral, integer weights, a tilted flag; LBP: the 16
// points of its 4 x 4 corner grid) and per tree its feature row,
// threshold, two f32 leaves (LBP: 8 subset words), per stage its last
// tree + 1 and its threshold (f64).
//
// Layout (tile_kernel): a CTA of kThreads threads a tile of tx x ty
// windows of one table row's grid (train/mine.py::tile_shape picks the
// shape: the most windows, up to 128, whose shared memory lets kMinBlocks
// CTAs share an SM: 16 x 4 at 24x24, 8 x 4 with tilted features).
// blockIdx.x finds its row by a binary search over the rows' first tiles;
// the tiles of a row cover its grid rows from the run's first to its last,
// all nx columns, and a window outside the run (the partial first grid
// row, the run's end, past the level's last column) has no thread. The CTA
//   1. builds the tile's pixels once into shared memory, (sx(tx-1) + ww) x
//      (sy(ty-1) + wh) of them (fewer at the level's edge): a lazy level by
//      build_level's INTER_LINEAR_EXACT integer arithmetic from its source
//      (ops/resize.py:62 _axis_tab_dev: integer round-half-even
//      coefficients, (v + 2^15) >> 16 clamped to 255; the row and column
//      tables once a tile), an eager level read from its image; a warp a
//      pixel row, a lane kCols8 columns 32 apart, so that many gathers are
//      in flight;
//   2. for Haar, each window's interior sum of squares: for each of the
//      tile's window rows, each column's squares summed down the interior
//      rows once, then a window sums its interior columns; builds the
//      tile's integrals once, uint32 in shared memory: the sum integral
//      (half rows, then columns); the tilted integral only for a cascade
//      with tilted features (ops/integral.py:35's row recurrence over the
//      tile's rows padded with tile height + 1 zero columns each side);
//   3. a thread a window: its norm factor (Haar; the interior's sum by
//      corners, sqrt(area * sq - sum^2) in f64, rounded to f32), then the
//      stages while each has fewer than kStageMax trees and more than
//      hand_live (a survivor a warp) of the tile's windows are alive: the
//      stage's tree records staged in shared memory (corner offsets turned
//      into tile offsets once) and read by every thread at once, its
//      feature values, leaves and the f64 prefix (Walk) carried a tree at a
//      time, the stage's check; a window stops at its first rejecting stage;
//   4. hands the survivors over: their walk states compacted in shared
//      memory, a warp a survivor finishes the stages 32 trees a step (a
//      lane a tree, its record from global memory), every lane carrying
//      the same Walk over the 32 leaves by shuffles.
//
// Why the tile's corners give the window's integers: a window's upright
// rect sums, LBP cell sums and interior sums are 4-corner differences of
// an integral, and such a difference is the sum of the rect's pixels
// wherever the integral starts, so the tile's corners at the window's
// offset give the window-local values. A rotated rect's 4-corner
// difference of a tilted integral is likewise the sum of the pixels in
// the rotated rect, as long as the integral holds every pixel of the
// cones its corners span: the tile's padding of tile height + 1 columns
// keeps the cones whole, and OpenCV's tilted features lie inside the
// window, those touching its edge too (tests/test_torch_mine.py holds
// every tilted feature of Haar ALL at 12x12 and 24x24 at windows on each
// of a tile's edges). uint32 sums wrap past 2^32, but every window's
// value is below 2^32 (shared memory bounds a tile), so the corner
// differences modulo 2^32 are exact.
//
// Bits that must hold (each tested, tests/test_torch_mine.py, and held
// against mine_ref on the card, utils/edges.py::mine_edge_cases):
//   (1) the prefix order. The stage sums are differences of one f64
//       prefix over the tree axis in scan_cumsum's order (train/split.py:
//       62, XLA:CPU's for jnp.cumsum): sequential inside blocks of 16,
//       each block plus the exclusive prefix of the block totals, which
//       is the same scan one level up; block 0 adds +0.0. A running sum
//       in tree order differs once T > 16. The prefix is causal, so a
//       window carries it (Walk): the sequential sum of its current block
//       of 16 from 0.0, and one accumulator and one exclusive prefix a
//       level of the recursion (kLevels of them: 16^(kLevels + 1) = 65 536
//       trees) that move up as each block completes. The top level's
//       sequential run has no +0.0, ours adds it: the two differ only in
//       the sign of a zero sum, which no compare sees.
//   (2) f32 division and the sqrt. Built with --fmad=false and without
//       --use_fast_math (_build.NVCC_FLAGS); the division is __fdiv_rn,
//       the sqrt __dsqrt_rn, the narrowing __double2float_rn: each
//       correctly rounded, as torch's and XLA:CPU's.
//   (3) the corner product is exact. The plain version's f32 product
//       equals the integer sum this kernel forms only while every partial
//       sum stays within 2^24; train/mine.py::check_exact asserts that
//       bound from the used features' weights and corners and raises
//       before a launch.
//   (4) windows and the table. A level's windows are the partial first
//       row of its grid and the full rows after it (negreader.py's
//       GridRun), one table row a run; empty levels have no row; an empty
//       stage list accepts every window; each window's byte is written
//       once, at row.out + (q - row.w0).
//
// Bound: each covered level pixel built and integrated once (chip_smoke's
// covered_pixels and mine_ops count that, integer work at the INT32 rate),
// the windows' norm factors and the trees actually evaluated beside it.
// The kernel builds a pixel (tx + 1)(ty + 1)/(tx ty) times, the tile's
// border again in the next tile (1.33 at 24x24, 16 x 4), against about 4
// times a window a warp (warp_kernel, kept for one more run beside it), and
// a 2-tree stage keeps every thread of a warp busy. What bounds it now is
// latency: shared memory holds 3 CTAs an SM (24 warps), the pixels' 4
// gathers each come from L2 more than L1 (the CTAs' shared memory leaves
// L1 little room), and the build's passes wait at barriers; the pixels
// take about half of its time (utils/tune_mine.py takes each part out).
// Windows sx = 12 words apart use 8 of the 32 banks whatever the pitch
// (12 = 4 x 3), so the walk's corner reads are 4-way conflicted at 24x24.
//
// warp_kernel is the design this replaced (a warp a window: its pixels,
// integrals and norm factor built anew for each window, 32 trees a step),
// reached only through cct_mine_warp, which utils/time_mine.py and
// chip_smoke (z) time beside tile_kernel on the same superbatches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;     // warp_kernel: windows a CTA, a warp each
constexpr int kThreads = 256;  // tile_kernel: threads a CTA
constexpr int kWarpsCta = kThreads / 32;
constexpr int kStageMax = 32;  // a stage of fewer trees runs a thread a window
constexpr int kRec = 32;       // ints of a staged tree record
constexpr int kCols8 = 8;      // pixel columns a lane builds at once, 32 apart
constexpr int kRun = 8;        // integral elements a thread loads before it sums them
constexpr int kMinBlocks = 3;  // CTAs an SM the registers must allow (train/mine.py::TILE_BUDGET)
constexpr int kLevels = 3;    // carried levels of the blocked scan above the leaves
constexpr int kBase = 16;     // scan_cumsum's block (SCAN_BASE)
constexpr int kMaxShared = 232448;  // a CTA's dynamic shared memory on sm_90
constexpr double kEps = 1e-5;  // CV_THRESHOLD_EPS

// level table columns (train/mine.py::LEVEL_COLS); kTile + kind: the row's
// first tile under that kind's tile shape
enum Col { kSrcOff, kEager, kSh, kSw, kDh, kDw, kOy, kOx, kNx, kW0, kCount, kOut, kTile,
           kCols = kTile + 3 };

enum Kind { kHaar = 0, kHaarTilted = 1, kLBP = 2 };

template <class I>
__device__ __forceinline__ I floor_div(I a, I b) {
  const I q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// _axis_tab_dev for one output coordinate d of an (ssz -> dsz) axis of an
// unpadded source: (idx0, idx1, coefficient of idx1), in I's arithmetic
template <class I>
__device__ __forceinline__ void axis_tab_in(int ssz, int dsz, int d, int* out) {
  const I two = I(2) * dsz;
  const I num = (I(2) * d + 1) * ssz - dsz;
  I sx = floor_div<I>(num, two);
  const I rem = num - sx * two;
  const I a = 128 * rem;  // >= 0
  const I q = a / dsz;
  const I r = a - q * dsz;
  I c = q + ((2 * r > dsz) || (2 * r == dsz && (q & 1)) ? 1 : 0);
  if (sx < 0) {
    sx = 0;
    c = 0;
  }
  if (sx >= ssz - 1) {
    sx = ssz > 1 ? ssz - 2 : 0;
    c = ssz > 1 ? 256 : 0;
  }
  if (d >= dsz) {
    sx = 0;
    c = 0;
  }
  out[0] = static_cast<int>(sx);
  out[1] = static_cast<int>(sx + 1 < ssz - 1 ? sx + 1 : ssz - 1);
  out[2] = static_cast<int>(c);
}

// 32-bit division where every term fits (any image up to 23 000 pixels a
// side), 64-bit beyond
__device__ __forceinline__ void axis_tab(int ssz, int dsz, int d, int* out) {
  if ((2LL * (d > dsz ? d : dsz) + 1) * ssz + 256LL * dsz < 0x7fffffffLL)
    axis_tab_in<int>(ssz, dsz, d, out);
  else
    axis_tab_in<long long>(ssz, dsz, d, out);
}

__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// ints of shared memory a warp of warp_kernel takes
__host__ __device__ __forceinline__ int warp_ints(int wh, int ww, int kind) {
  const int cells = (wh + 1) * (ww + 1);
  int n = 3 * wh + 3 * ww + (wh * ww + 3) / 4 + cells;
  if (kind == kHaarTilted) n += cells + 3 * (ww + 2 * (wh + 1) + 1);
  return n;
}

// the blocked scan's carried state
struct Prefix {
  double acc[kLevels + 1];  // acc[l]: level l's sequential sum in its current block
  double ex[kLevels + 2];   // ex[l]: the exclusive prefix level l - 1's current block adds
  int n[kLevels + 1];       // elements of level l's current block

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int l = 0; l <= kLevels; ++l) {
      acc[l] = 0.0;
      n[l] = 0;
    }
#pragma unroll
    for (int l = 0; l < kLevels + 2; ++l) ex[l] = 0.0;
  }

  // a completed block of level 0 with sequential total x: it becomes the
  // next element of level 1, whose prefix there is level 0's next
  // block's exclusive prefix; a level whose block completes carries its
  // total up before it restarts from 0.0
  __device__ __forceinline__ void push(double x) {
#pragma unroll
    for (int l = 1; l <= kLevels; ++l) {
      acc[l] = acc[l] + x;
      ex[l] = acc[l] + ex[l + 1];
      if (++n[l] < kBase) break;
      x = acc[l];
      acc[l] = 0.0;
      n[l] = 0;
    }
  }
};

// one window's walk over the tree axis, a leaf at a time: the prefix at
// each tree in scan_cumsum's order (bit (1))
struct Walk {
  Prefix pre;
  double s;  // the sequential sum of the current block of 16, from 0.0
  int pos;   // leaves in the current block

  __device__ __forceinline__ void init() {
    pre.init();
    s = 0.0;
    pos = 0;
  }

  __device__ __forceinline__ double add(double x) {
    s = s + x;
    const double p = s + pre.ex[1];
    if (++pos == kBase) {
      pre.push(s);
      s = 0.0;
      pos = 0;
    }
    return p;
  }
};

// a survivor handed from its thread to a warp
struct HandState {
  Walk w;
  double start;  // the prefix at the previous stage's end
  long long g;   // its output byte
  int si;        // the next stage
  int base;      // its window's corner (0, 0) in the tile's integrals
  float nf;
};
constexpr int kHandInts = static_cast<int>(sizeof(HandState) / 4);
static_assert(sizeof(HandState) == 136, "train/mine.py::HAND_INTS mirrors this");

// a tile's shared memory, in ints (train/mine.py::tile_layout mirrors it)
struct Layout {
  int pw, ph;    // the tile's pixels across and down
  int pitch;     // the integrals' row pitch, odd
  int t;         // the tilted integral
  int u;         // the region the build and the walk take in turn
  int pix, rtab, ctab, carry, vsum, trow;  // the build's: pixels (bytes), axis tables, row
                                           // halves' carries, column sums of squares,
                                           // recurrence rows
  int rec, hand;              // the walk's: staged tree records, hand-off states
  int ints;
};

__host__ __device__ inline Layout tile_layout(int ww, int wh, int kind, int tx, int ty) {
  Layout L;
  L.pw = (ww / 2) * (tx - 1) + ww;
  L.ph = (wh / 2) * (ty - 1) + wh;
  L.pitch = (L.pw + 1) | 1;
  const int cells = (L.ph + 1) * L.pitch;
  L.t = cells;
  L.u = (kind == kHaarTilted ? 2 : 1) * cells;
  L.u += L.u & 1;  // 8-byte aligned for the hand-off states
  L.pix = L.u;
  L.rtab = L.pix + (L.ph * L.pw + 3) / 4;
  L.ctab = L.rtab + 3 * L.ph;
  L.carry = L.ctab + 3 * L.pw;
  L.vsum = L.carry + L.ph;
  L.trow = L.vsum + (kind == kLBP ? 0 : ty * L.pw);
  const int build = L.trow + (kind == kHaarTilted ? 3 * (L.pw + 2 * (L.ph + 1) + 1) : 0);
  L.rec = L.u;
  L.hand = L.rec + kStageMax * kRec;
  const int walk = L.hand + tx * ty * kHandInts;
  L.ints = build > walk ? build : walk;
  return L;
}

// a window-local corner offset r (ww + 1) + c as the tile's r pitch + c;
// r by a multiply-high with ceil(2^32 / (ww + 1)), exact below 2^32 / (ww + 1)
__device__ __forceinline__ int tile_off(int o, int w1, unsigned magic, int pitch) {
  const int r = static_cast<int>(__umulhi(static_cast<unsigned>(o), magic));
  return r * pitch + (o - r * w1);
}

__device__ __forceinline__ int corner4(const unsigned* I, int a, int b, int c, int d) {
  return static_cast<int>(I[a] - I[b] - I[c] + I[d]);
}

// the leaf a tree gives a window. R reads the tree's record: staged in
// shared memory (StagedRec) or from the global arrays (GlobalRec)
template <int K, class R>
__device__ __forceinline__ double tree_leaf(const R& rc, const unsigned* S, const unsigned* T,
                                            int base, float nf) {
  bool left;
  if (K == kLBP) {
    int gp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) gp[i] = static_cast<int>(S[base + rc.pt(i)]);
    int cs[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        cs[r * 3 + c] = gp[r * 4 + c] - gp[r * 4 + c + 1] - gp[(r + 1) * 4 + c] +
                        gp[(r + 1) * 4 + c + 1];
    const int cv = cs[4];
    // LBP_BITS: (0,0) 128, (0,1) 64, (0,2) 32, (1,2) 16, (2,2) 8,
    // (2,1) 4, (2,0) 2, (1,0) 1
    const int code = (cs[0] >= cv) << 7 | (cs[1] >= cv) << 6 | (cs[2] >= cv) << 5 |
                     (cs[5] >= cv) << 4 | (cs[8] >= cv) << 3 | (cs[7] >= cv) << 2 |
                     (cs[6] >= cv) << 1 | (cs[3] >= cv);
    const unsigned word = rc.sub(code >> 5);
    left = ((word >> (code & 31)) & 1u) != 0;
  } else {
    const unsigned* I = (K == kHaarTilted && rc.tilt()) ? T : S;
    int raw = 0;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int w = rc.w(r);
      if (w != 0)
        raw += w * corner4(I, base + rc.off(4 * r), base + rc.off(4 * r + 1),
                           base + rc.off(4 * r + 2), base + rc.off(4 * r + 3));
    }
    const float v = nf != 0.f ? __fdiv_rn(__int2float_rn(raw), nf) : 0.f;
    left = v <= rc.thr();
  }
  return static_cast<double>(left ? rc.leaf_l() : rc.leaf_r());
}

// a staged record: Haar [0, 12) tile offsets, [12, 15) weights, 15 the
// tilted flag, 16 the threshold, 17 and 18 the leaves; LBP [0, 16) tile
// offsets, [16, 24) subset words, 24 and 25 the leaves
template <int K>
struct StagedRec {
  static constexpr int kLeaf = K == kLBP ? 24 : 17;
  const int* r;
  __device__ int off(int i) const { return r[i]; }
  __device__ int w(int i) const { return r[12 + i]; }
  __device__ int tilt() const { return r[15]; }
  __device__ float thr() const { return __int_as_float(r[16]); }
  __device__ int pt(int i) const { return r[i]; }
  __device__ unsigned sub(int i) const { return static_cast<unsigned>(r[16 + i]); }
  __device__ float leaf_l() const { return __int_as_float(r[kLeaf]); }
  __device__ float leaf_r() const { return __int_as_float(r[kLeaf + 1]); }
};

// the tree tables as tile_kernel takes them
struct Trees {
  const int* foff;
  const int* fw;
  const int* ftilt;
  const int* fpts;
  const int* ti;
  const float* thr;
  const float* leaf_l;
  const float* leaf_r;
  const int* subsets;
  const int* stage_end;
  const double* stage_thr;
  int n_trees, n_stages;
};

// a record read from the global tables, corner offsets turned into tile
// offsets as they are read
struct GlobalRec {
  Trees tr;
  int t, k, w1, pitch;
  unsigned magic;
  __device__ int off(int i) const { return tile_off(tr.foff[12 * k + i], w1, magic, pitch); }
  __device__ int w(int i) const { return tr.fw[3 * k + i]; }
  __device__ int tilt() const { return tr.ftilt[k]; }
  __device__ float thr() const { return tr.thr[t]; }
  __device__ int pt(int i) const { return tile_off(tr.fpts[16 * k + i], w1, magic, pitch); }
  __device__ unsigned sub(int i) const { return static_cast<unsigned>(tr.subsets[8 * t + i]); }
  __device__ float leaf_l() const { return tr.leaf_l[t]; }
  __device__ float leaf_r() const { return tr.leaf_r[t]; }
};

// word f of tree t's staged record
template <int K>
__device__ __forceinline__ int record_word(const Trees& tr, int t, int f, int w1, unsigned magic,
                                           int pitch) {
  const int k = tr.ti[t];
  if (K == kLBP) {
    if (f < 16) return tile_off(tr.fpts[16 * k + f], w1, magic, pitch);
    if (f < 24) return tr.subsets[8 * t + f - 16];
    if (f == 24) return __float_as_int(tr.leaf_l[t]);
    if (f == 25) return __float_as_int(tr.leaf_r[t]);
    return 0;
  }
  if (f < 12) return tile_off(tr.foff[12 * k + f], w1, magic, pitch);
  if (f < 15) return tr.fw[3 * k + f - 12];
  if (f == 15) return tr.ftilt[k];
  if (f == 16) return __float_as_int(tr.thr[t]);
  if (f == 17) return __float_as_int(tr.leaf_l[t]);
  if (f == 18) return __float_as_int(tr.leaf_r[t]);
  return 0;
}

// a tile's integral of the pixels into S, uint32,
// row 0 and column 0 zero: each row's prefix in two halves, a thread a
// half row (the first half's total kept in carry), then each column's
// prefix down the rows, a thread a column, adding the carry right of the
// halves' cut; barriers before and after
__device__ __forceinline__ void integral(unsigned* __restrict__ S,
                                         const uint8_t* __restrict__ pix, int pw, int P, int phe,
                                         int pwe, unsigned* __restrict__ carry, int tid) {
  const int cut = pwe / 2;
  __syncthreads();
  for (int i = tid; i < 2 * phe; i += kThreads) {
    const int half = i >= phe, r = half ? i - phe : i;
    const int c0 = half ? cut : 0, c_end = half ? pwe : cut;
    const uint8_t* px = pix + r * pw;
    unsigned* out = S + (r + 1) * P + 1;
    unsigned run = 0;
    if (!half) out[-1] = 0;
    int c = c0;
    for (; c + kRun <= c_end; c += kRun) {  // kRun loads in flight, then their sums
      unsigned v[kRun];
#pragma unroll
      for (int k = 0; k < kRun; ++k) v[k] = px[c + k];
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        run += v[k];
        out[c + k] = run;
      }
    }
    for (; c < c_end; ++c) {
      run += px[c];
      out[c] = run;
    }
    if (!half) carry[r] = run;
  }
  __syncthreads();
  for (int c = tid; c <= pwe; c += kThreads) {
    const unsigned* add = c > cut ? carry : nullptr;
    unsigned run = 0;
    int r = 1;
    for (; r + kRun <= phe + 1; r += kRun) {
      unsigned v[kRun];
#pragma unroll
      for (int k = 0; k < kRun; ++k) v[k] = S[(r + k) * P + c] + (add ? add[r + k - 1] : 0u);
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        run += v[k];
        S[(r + k) * P + c] = run;
      }
    }
    for (; r <= phe; ++r) {
      run += S[r * P + c] + (add ? add[r - 1] : 0u);
      S[r * P + c] = run;
    }
    S[c] = 0;
  }
  __syncthreads();
}

template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    tile_kernel(const long long* __restrict__ table, int rows, int tx, int ty,
                const uint8_t* __restrict__ lazy, const uint8_t* __restrict__ eager, int ww,
                int wh, Trees tr, int hand_live, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int n_hand;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout L = tile_layout(ww, wh, K, tx, ty);
  const int P = L.pitch;
  const int sx = ww / 2, sy = wh / 2;

  // the table row and the tile
  const long long blk = blockIdx.x;
  int lo = 0, hi = rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[static_cast<long long>(mid) * kCols + kTile + K] <= blk) lo = mid;
    else hi = mid - 1;
  }
  const long long* row = table + static_cast<long long>(lo) * kCols;
  const long long nx = row[kNx], w0 = row[kW0], cnt = row[kCount];
  const long long r0 = w0 / nx, r1 = (w0 + cnt - 1) / nx;
  const long long tiles_x = (nx + tx - 1) / tx;
  const long long k = blk - row[kTile + K];
  const long long gy0 = r0 + (k / tiles_x) * ty, gx0 = (k % tiles_x) * tx;
  const int ncol = static_cast<int>(min(static_cast<long long>(tx), nx - gx0));
  const int nrow = static_cast<int>(min(static_cast<long long>(ty), r1 - gy0 + 1));
  const int pwe = sx * (ncol - 1) + ww, phe = sy * (nrow - 1) + wh;  // pixels this tile needs
  const int Y0 = static_cast<int>(row[kOy] + gy0 * sy), X0 = static_cast<int>(row[kOx] + gx0 * sx);
  const int sh = static_cast<int>(row[kSh]), sw = static_cast<int>(row[kSw]);
  const int dh = static_cast<int>(row[kDh]), dw = static_cast<int>(row[kDw]);

  // this thread's window: (a, b) of the tile, grid index q
  const int a = tid / tx, b = tid - (tid / tx) * tx;
  const long long q = (gy0 + a) * nx + gx0 + b;
  const bool has = tid < tx * ty && a < nrow && b < ncol && q >= w0 && q < w0 + cnt;
  const long long g = row[kOut] + (q - w0);
  const int base = a * sy * P + b * sx;

  unsigned* S = reinterpret_cast<unsigned*>(smem);
  unsigned* T = S + L.t;
  uint8_t* pix = reinterpret_cast<uint8_t*>(smem + L.pix);
  int* rtab = smem + L.rtab;
  int* ctab = smem + L.ctab;
  unsigned* carry = reinterpret_cast<unsigned*>(smem + L.carry);
  unsigned* vsum = reinterpret_cast<unsigned*>(smem + L.vsum);

  // 1. the axis tables
  const bool is_eager = row[kEager] != 0;
  if (!is_eager) {
    for (int r = tid; r < phe; r += kThreads) axis_tab(sh, dh, Y0 + r, rtab + 3 * r);
    for (int c = tid; c < pwe; c += kThreads) axis_tab(sw, dw, X0 + c, ctab + 3 * c);
  }
  __syncthreads();

  // the pixels, each once: a warp a pixel row at a time, a lane 8 columns
  // 32 apart (their tables in registers), so 32 gathers are in flight
  const uint8_t* src = (is_eager ? eager : lazy) + row[kSrcOff];
  for (int cb = 0; cb < pwe; cb += 32 * kCols8) {
    int c0[kCols8], cw[kCols8];
#pragma unroll
    for (int j = 0; j < kCols8; ++j) {
      const int c = min(cb + lane + 32 * j, pwe - 1);
      c0[j] = is_eager ? X0 + c : ctab[3 * c];
      cw[j] = is_eager ? 0 : ctab[3 * c + 2];
    }
    for (int r = warp; r < phe; r += kWarpsCta) {
      int v[kCols8];
      if (is_eager) {
        const uint8_t* s0 = src + static_cast<long long>(Y0 + r) * sw;
#pragma unroll
        for (int j = 0; j < kCols8; ++j) v[j] = s0[c0[j]];
      } else {
        const int* ry = rtab + 3 * r;
        const uint8_t* s0 = src + static_cast<long long>(ry[0]) * sw;
        const uint8_t* s1 = src + static_cast<long long>(ry[1]) * sw;
        const int wy = ry[2];
        const bool row_in = Y0 + r < dh;
#pragma unroll
        for (int j = 0; j < kCols8; ++j) {
          // idx1 = idx0 + 1 (axis_tab), but for a source 1 pixel wide, whose
          // idx1 coefficient is 0 (the arena's pad byte keeps the read inside)
          const uint8_t* p0 = s0 + c0[j];
          const uint8_t* p1 = s1 + c0[j];
          const int v0 = (256 - wy) * p0[0] + wy * p1[0];
          const int v1 = (256 - wy) * p0[1] + wy * p1[1];
          const int h = (256 - cw[j]) * v0 + cw[j] * v1;
          v[j] = row_in && X0 + cb + lane + 32 * j < dw ? min((h + (1 << 15)) >> 16, 255) : 0;
        }
      }
#pragma unroll
      for (int j = 0; j < kCols8; ++j) {
        const int c = cb + lane + 32 * j;
        if (c < pwe) pix[r * L.pw + c] = static_cast<uint8_t>(v[j]);
      }
    }
  }
  __syncthreads();

  // 2. for Haar each window's interior sum of squares: for each of the
  // tile's window rows, each column's squares down the interior rows, then
  // a window's interior columns of its row; then the sum integral, uint32
  const int rh = wh - 2, rw = ww - 2;
  const int at = base + P + 1;  // the window's interior corner (1, 1)
  unsigned sq = 0;
  if (K != kLBP) {
    for (int wr = 0; wr < nrow; ++wr) {
      for (int c = tid; c < pwe; c += kThreads) {
        const uint8_t* px = pix + (wr * sy + 1) * L.pw + c;
        unsigned col = 0;
        for (int r = 0; r < rh; ++r) {
          const unsigned v = px[r * L.pw];
          col += v * v;
        }
        vsum[wr * L.pw + c] = col;
      }
    }
    __syncthreads();
    if (has) {
      const unsigned* vs = vsum + a * L.pw + b * sx + 1;
      for (int c = 0; c < rw; ++c) sq += vs[c];
    }
  }
  integral(S, pix, L.pw, P, phe, pwe, carry, tid);

  if (K == kHaarTilted) {
    // T[Y][X] = T[Y-1][X-1] + T[Y-1][X+1] - T[Y-2][X] + img[Y-1][X-1] +
    // img[Y-2][X-1] over rows padded with p = phe + 1 zero columns each
    // side (row length rl), cropped to [p, p + pwe]
    const int p = phe + 1, rl = pwe + 2 * p + 1;
    int* tm2 = smem + L.trow;
    int* tm1 = tm2 + rl;
    int* tn = tm1 + rl;
    for (int x = tid; x < rl; x += kThreads) tm2[x] = tm1[x] = 0;
    for (int c = tid; c <= pwe; c += kThreads) T[c] = 0;
    __syncthreads();
    for (int y = 0; y < phe; ++y) {
      for (int x = tid; x < rl; x += kThreads) {
        const int xc = x - 1 - p;  // the tile column of padded column x - 1
        const bool in = xc >= 0 && xc < pwe;
        const int r1 = in ? pix[y * L.pw + xc] : 0;
        const int r0 = (y > 0 && in) ? pix[(y - 1) * L.pw + xc] : 0;
        const int left = x >= 1 ? tm1[x - 1] : 0;
        const int right = x < rl - 1 ? tm1[x + 1] : 0;
        tn[x] = left + right - tm2[x] + r1 + r0;
      }
      __syncthreads();
      for (int c = tid; c <= pwe; c += kThreads)
        T[(y + 1) * P + c] = static_cast<unsigned>(tn[p + c]);
      int* t = tm2;
      tm2 = tm1;
      tm1 = tn;
      tn = t;
    }
  }
  __syncthreads();  // the integrals are whole; the build's region is free

  // 3. the norm factor over the interior rows 1..wh-2, columns 1..ww-2
  float nf = 0.f;
  if (K != kLBP && has) {
    const long long sum = corner4(S, at, at + rw, at + rh * P, at + rh * P + rw);
    long long val = static_cast<long long>(rh) * rw * static_cast<long long>(sq) - sum * sum;
    if (val < 0) val = 0;
    nf = __double2float_rn(__dsqrt_rn(static_cast<double>(val)));
  }

  // the short stages, a thread a window
  const int w1 = ww + 1;
  const unsigned magic = 0xffffffffu / static_cast<unsigned>(w1) + 1u;
  int* rec = smem + L.rec;
  Walk wk;
  wk.init();
  double start = 0.0;  // the prefix at the previous stage's end (stage 0: 0.0)
  bool alive = has;
  bool hand = false;
  int si = 0;
  while (si < tr.n_stages) {
    const int tb = si ? tr.stage_end[si - 1] : 0, te = tr.stage_end[si];
    const int live = __syncthreads_count(alive);  // also: the last stage's records are read
    if (live == 0) break;
    if (te - tb >= kStageMax || live <= hand_live) {
      hand = true;
      break;
    }
    for (int i = tid; i < (te - tb) * kRec; i += kThreads)
      rec[i] = record_word<K>(tr, tb + i / kRec, i % kRec, w1, magic, P);
    __syncthreads();
    if (alive) {
      StagedRec<K> rc;
      double pref = start;
      for (int t = tb; t < te; ++t) {
        rc.r = rec + (t - tb) * kRec;
        pref = wk.add(tree_leaf<K>(rc, S, T, base, nf));
      }
      if (pref - start < tr.stage_thr[si] - kEps) {
        alive = false;
        out[g] = 0;
      } else {
        start = pref;
      }
    }
    ++si;
  }
  if (!hand) {
    if (alive) out[g] = 1;
    return;
  }

  // 4. the hand-off: the survivors' states compacted, a warp a survivor
  if (tid == 0) n_hand = 0;
  __syncthreads();
  HandState* hs = reinterpret_cast<HandState*>(smem + L.hand);
  if (alive) {
    HandState& z = hs[atomicAdd(&n_hand, 1)];
    z.w = wk;
    z.start = start;
    z.g = g;
    z.si = si;
    z.base = base;
    z.nf = nf;
  }
  __syncthreads();
  const int n_alive = n_hand;
  const int t_end = tr.stage_end[tr.n_stages - 1];
  for (int h = warp; h < n_alive; h += kWarpsCta) {
    Walk w = hs[h].w;
    double st = hs[h].start;
    int s = hs[h].si;
    const int wb = hs[h].base;
    const float wnf = hs[h].nf;
    bool ok = true;
    int te = tr.stage_end[s] - 1;
    for (int t0 = s ? tr.stage_end[s - 1] : 0; ok && s < tr.n_stages && t0 < t_end; t0 += 32) {
      const int t = t0 + lane;
      double x = 0.0;
      if (t < t_end) {
        const GlobalRec rc{tr, t, tr.ti[t], w1, P, magic};
        x = tree_leaf<K>(rc, S, T, wb, wnf);
      }
      const int m = min(32, t_end - t0);
      for (int j = 0; j < m; ++j) {
        const double pref = w.add(__shfl_sync(kFull, x, j));
        while (t0 + j == te) {  // each stage that ends at this tree
          if (pref - st < tr.stage_thr[s] - kEps) {
            ok = false;
            break;
          }
          st = pref;
          if (++s == tr.n_stages) break;
          te = tr.stage_end[s] - 1;
        }
        if (!ok || s == tr.n_stages) break;
      }
    }
    if (lane == 0) out[hs[h].g] = ok ? 1 : 0;
  }
}

// PR 18's design, a warp a window (see the head of the file)
template <int K>
__global__ void __launch_bounds__(kWarps * 32)
    warp_kernel(const long long* __restrict__ table, int rows, const uint8_t* __restrict__ lazy,
                const uint8_t* __restrict__ eager, int ww, int wh,
                const int* __restrict__ foff, const int* __restrict__ fw,
                const int* __restrict__ ftilt, const int* __restrict__ fpts,
                const int* __restrict__ ti, const float* __restrict__ thr,
                const float* __restrict__ leaf_l, const float* __restrict__ leaf_r,
                const int* __restrict__ subsets, int n_trees,
                const int* __restrict__ stage_end, const double* __restrict__ stage_thr,
                int n_stages, uint8_t* __restrict__ out, long long n) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (g >= n) return;  // whole warps leave together
  int* base = smem + warp * warp_ints(wh, ww, K);
  int* rtab = base;                  // 3 a window row: idx0, idx1, coefficient
  int* ctab = rtab + 3 * wh;         // 3 a window column
  uint8_t* pix = reinterpret_cast<uint8_t*>(ctab + 3 * ww);
  const int w1 = ww + 1;
  int* S = ctab + 3 * ww + (wh * ww + 3) / 4;  // (wh+1) x (ww+1)
  int* T = S + (wh + 1) * w1;                  // tilted, same shape
  int* trow = T + (wh + 1) * w1;               // 3 padded rows of the recurrence

  // 1. the table row and the window's origin on its level
  int lo = 0, hi = rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[static_cast<long long>(mid) * kCols + kOut] <= g) lo = mid;
    else hi = mid - 1;
  }
  const long long* row = table + static_cast<long long>(lo) * kCols;
  const long long q = row[kW0] + (g - row[kOut]);
  const int nx = static_cast<int>(row[kNx]);
  const int y0 = static_cast<int>(row[kOy] + (q / nx) * (wh / 2));
  const int x0 = static_cast<int>(row[kOx] + (q % nx) * (ww / 2));
  const int sh = static_cast<int>(row[kSh]), sw = static_cast<int>(row[kSw]);
  const int dh = static_cast<int>(row[kDh]), dw = static_cast<int>(row[kDw]);

  // 2. the pixels
  if (row[kEager]) {
    const uint8_t* img = eager + row[kSrcOff];
    for (int i = lane; i < wh * ww; i += 32) {
      const int r = i / ww, c = i - r * ww;
      pix[i] = img[static_cast<long long>(y0 + r) * sw + (x0 + c)];
    }
  } else {
    for (int r = lane; r < wh; r += 32) axis_tab_in<long long>(sh, dh, y0 + r, rtab + 3 * r);
    for (int c = lane; c < ww; c += 32) axis_tab_in<long long>(sw, dw, x0 + c, ctab + 3 * c);
    __syncwarp();
    const uint8_t* src = lazy + row[kSrcOff];
    for (int i = lane; i < wh * ww; i += 32) {
      const int r = i / ww, c = i - r * ww;
      const int* ry = rtab + 3 * r;
      const int* cx = ctab + 3 * c;
      const uint8_t* s0 = src + static_cast<long long>(ry[0]) * sw;
      const uint8_t* s1 = src + static_cast<long long>(ry[1]) * sw;
      const int v0 = (256 - ry[2]) * s0[cx[0]] + ry[2] * s1[cx[0]];
      const int v1 = (256 - ry[2]) * s0[cx[1]] + ry[2] * s1[cx[1]];
      const int h = (256 - cx[2]) * v0 + cx[2] * v1;
      const int v = min((h + (1 << 15)) >> 16, 255);
      pix[i] = (y0 + r < dh && x0 + c < dw) ? static_cast<uint8_t>(v) : 0;
    }
  }
  __syncwarp();

  // 3. the sum integral: row 0 and column 0 zero; a column sum a lane,
  // scanned across the lanes, plus the previous 32 columns' last value
  for (int c = lane; c < w1; c += 32) S[c] = 0;
  for (int r = 1 + lane; r <= wh; r += 32) S[r * w1] = 0;
  for (int cb = 0; cb < ww; cb += 32) {
    const int c = cb + lane;
    int col = 0;
    __syncwarp();  // the previous chunk's last column is written
    for (int r = 0; r < wh; ++r) {
      col += c < ww ? pix[r * ww + c] : 0;
      const int incl = warp_scan(col, lane);
      const int carry = cb ? S[(r + 1) * w1 + cb] : 0;
      if (c < ww) S[(r + 1) * w1 + c + 1] = incl + carry;
    }
  }

  if (K == kHaarTilted) {
    // T[Y][X] = T[Y-1][X-1] + T[Y-1][X+1] - T[Y-2][X] + img[Y-1][X-1] +
    // img[Y-2][X-1] over rows padded with p = wh + 1 zero columns each
    // side (pw = ww + 2p columns, row length pw + 1), cropped to [p, p+ww]
    const int p = wh + 1, pw = ww + 2 * p, rl = pw + 1;
    int* tm2 = trow;
    int* tm1 = trow + rl;
    int* tn = trow + 2 * rl;
    for (int x = lane; x < rl; x += 32) tm2[x] = tm1[x] = 0;
    for (int c = lane; c < w1; c += 32) T[c] = 0;
    __syncwarp();
    for (int y = 0; y < wh; ++y) {
      for (int x = lane; x < rl; x += 32) {
        const int xc = x - 1 - p;  // the window column of padded column x - 1
        const int r1 = (xc >= 0 && xc < ww) ? pix[y * ww + xc] : 0;
        const int r0 = (y > 0 && xc >= 0 && xc < ww) ? pix[(y - 1) * ww + xc] : 0;
        const int left = x >= 1 ? tm1[x - 1] : 0;
        const int right = x < pw ? tm1[x + 1] : 0;
        tn[x] = left + right - tm2[x] + r1 + r0;
      }
      __syncwarp();
      for (int c = lane; c < w1; c += 32) T[(y + 1) * w1 + c] = tn[p + c];
      int* t = tm2;
      tm2 = tm1;
      tm1 = tn;
      tn = t;
      __syncwarp();
    }
  }
  __syncwarp();

  // 4. the norm factor over the interior rows 1..wh-2, columns 1..ww-2
  float nf = 0.f;
  if (K != kLBP) {
    long long sq = 0;
    for (int i = lane; i < wh * ww; i += 32) {
      const int r = i / ww, c = i - r * ww;
      if (r >= 1 && r <= wh - 2 && c >= 1 && c <= ww - 2) sq += pix[i] * pix[i];
    }
    sq = warp_sum(sq);
    const int rh = wh - 2, rw = ww - 2;
    const long long sum = static_cast<long long>(S[w1 + 1]) - S[w1 + 1 + rw] -
                          S[(1 + rh) * w1 + 1] + S[(1 + rh) * w1 + 1 + rw];
    long long val = static_cast<long long>(rh) * rw * sq - sum * sum;
    if (val < 0) val = 0;
    nf = __double2float_rn(__dsqrt_rn(static_cast<double>(val)));
  }

  // 5. the trees, 32 a step, and the stages that end among them
  Prefix pre;
  pre.init();
  double start = 0.0;  // the prefix at the previous stage's end (stage 0: 0.0)
  int si = 0;
  bool accepted = true;
  for (int t0 = 0; si < n_stages; t0 += 32) {
    const int t = t0 + lane;
    double x = 0.0;
    if (t < n_trees) {
      const int k = ti[t];
      bool left;
      if (K == kLBP) {
        const int* pt = fpts + 16 * k;
        int gp[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) gp[i] = S[pt[i]];
        int cs[9];
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            cs[r * 3 + c] = gp[r * 4 + c] - gp[r * 4 + c + 1] - gp[(r + 1) * 4 + c] +
                            gp[(r + 1) * 4 + c + 1];
        const int cv = cs[4];
        // LBP_BITS: (0,0) 128, (0,1) 64, (0,2) 32, (1,2) 16, (2,2) 8,
        // (2,1) 4, (2,0) 2, (1,0) 1
        const int code = (cs[0] >= cv) << 7 | (cs[1] >= cv) << 6 | (cs[2] >= cv) << 5 |
                         (cs[5] >= cv) << 4 | (cs[8] >= cv) << 3 | (cs[7] >= cv) << 2 |
                         (cs[6] >= cv) << 1 | (cs[3] >= cv);
        const unsigned word = static_cast<unsigned>(subsets[8 * t + (code >> 5)]);
        left = ((word >> (code & 31)) & 1u) != 0;
      } else {
        const int* I = (K == kHaarTilted && ftilt[k]) ? T : S;
        const int* o = foff + 12 * k;
        int raw = 0;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const int w = fw[3 * k + r];
          if (w != 0) raw += w * (I[o[4 * r]] - I[o[4 * r + 1]] - I[o[4 * r + 2]] + I[o[4 * r + 3]]);
        }
        const float v = nf != 0.f ? __fdiv_rn(__int2float_rn(raw), nf) : 0.f;
        left = v <= thr[t];
      }
      x = static_cast<double>(left ? leaf_l[t] : leaf_r[t]);
    }
    // (1): each lane's sequential sum inside its block of 16 ...
    const int blk = lane & 16, pos = lane & 15;
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < kBase; ++k) {
      const double v = __shfl_sync(kFull, x, blk + k);
      if (k <= pos) s = s + v;
    }
    // ... plus its block's exclusive prefix; block A's total moves up the
    // levels before block B's prefix is read
    const double ex_a = pre.ex[1];
    pre.push(__shfl_sync(kFull, s, 15));
    const double ex_b = pre.ex[1];
    pre.push(__shfl_sync(kFull, s, 31));  // past the last tree it is never read
    const double pref = s + (lane < 16 ? ex_a : ex_b);
    while (si < n_stages) {
      const int te = stage_end[si] - 1;
      if (te >= t0 + 32) break;
      const double pe = __shfl_sync(kFull, pref, te - t0);
      if (pe - start < stage_thr[si] - kEps) {
        accepted = false;
        break;
      }
      start = pe;
      ++si;
    }
    if (!accepted) break;
  }
  if (lane == 0) out[g] = accepted ? 1 : 0;
}

template <int K>
int launch_warp(const long long* table, int rows, const uint8_t* lazy, const uint8_t* eager,
                int ww, int wh, const int* foff, const int* fw, const int* ftilt,
                const int* fpts, const int* ti, const float* thr, const float* ll,
                const float* lr, const int* sub, int n_trees, const int* send,
                const double* sthr, int n_stages, uint8_t* out, long long n, cudaStream_t st) {
  const int bytes = kWarps * warp_ints(wh, ww, K) * 4;
  if (bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e =
      cudaFuncSetAttribute(warp_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (n + kWarps - 1) / kWarps;
  warp_kernel<K><<<static_cast<unsigned>(blocks), kWarps * 32, bytes, st>>>(
      table, rows, lazy, eager, ww, wh, foff, fw, ftilt, fpts, ti, thr, ll, lr, sub, n_trees,
      send, sthr, n_stages, out, n);
  return static_cast<int>(cudaGetLastError());
}


template <int K>
int launch_tile(const long long* table, int rows, long long n_tiles, int tx, int ty,
                const uint8_t* lazy, const uint8_t* eager, int ww, int wh, const Trees& tr,
                int hand_live, uint8_t* out, cudaStream_t st) {
  const int bytes = tile_layout(ww, wh, K, tx, ty).ints * 4;
  if (bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e =
      cudaFuncSetAttribute(tile_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  tile_kernel<K><<<static_cast<unsigned>(n_tiles), kThreads, bytes, st>>>(
      table, rows, tx, ty, lazy, eager, ww, wh, tr, hand_live, out);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int tile_info(int ww, int wh, int tx, int ty, int* bytes, int* ctas_per_sm) {
  *bytes = tile_layout(ww, wh, K, tx, ty).ints * 4;
  if (*bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e =
      cudaFuncSetAttribute(tile_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, tile_kernel<K>, kThreads, *bytes));
}

bool bad_tile(int ww, int wh, int kind, int tx, int ty) {
  return ww < 2 || wh < 2 || kind < 0 || kind > 2 || tx < 1 || ty < 1 || tx * ty > kThreads;
}

}  // namespace

// kind: 0 Haar upright, 1 Haar with tilted features, 2 LBP. n_tiles: the
// table's tiles under the kind's tile shape tx x ty (its column kTile +
// kind holds each row's first); hand_live: a tile hands its survivors to
// warps once no more than this many of its windows are alive
extern "C" int cct_mine(const void* table, int rows, long long n_tiles, int tx, int ty,
                        int hand_live, const void* lazy, const void* eager, int ww, int wh,
                        int kind, const void* foff, const void* fw, const void* ftilt,
                        const void* fpts, const void* ti, const void* thr, const void* leaf_l,
                        const void* leaf_r, const void* subsets, int n_trees,
                        const void* stage_end, const void* stage_thr, int n_stages, void* out,
                        long long n, void* stream) {
  if (rows < 0 || n < 0 || n_tiles < 0 || bad_tile(ww, wh, kind, tx, ty) || n_trees < 0 ||
      n_stages < 0 || n_trees > (1 << (4 * (kLevels + 1))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (rows == 0 || n_tiles == 0 || n_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Trees tr{static_cast<const int*>(foff),     static_cast<const int*>(fw),
                 static_cast<const int*>(ftilt),    static_cast<const int*>(fpts),
                 static_cast<const int*>(ti),       static_cast<const float*>(thr),
                 static_cast<const float*>(leaf_l), static_cast<const float*>(leaf_r),
                 static_cast<const int*>(subsets),  static_cast<const int*>(stage_end),
                 static_cast<const double*>(stage_thr), n_trees, n_stages};
  const auto* tb = static_cast<const long long*>(table);
  const auto* lz = static_cast<const uint8_t*>(lazy);
  const auto* eg = static_cast<const uint8_t*>(eager);
  auto* ob = static_cast<uint8_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kHaar:
      return launch_tile<kHaar>(tb, rows, n_tiles, tx, ty, lz, eg, ww, wh, tr, hand_live, ob, st);
    case kHaarTilted:
      return launch_tile<kHaarTilted>(tb, rows, n_tiles, tx, ty, lz, eg, ww, wh, tr, hand_live,
                                      ob, st);
    default:
      return launch_tile<kLBP>(tb, rows, n_tiles, tx, ty, lz, eg, ww, wh, tr, hand_live, ob, st);
  }
}

// A tile shape's shared bytes a CTA and the CTAs an SM holds.
extern "C" int cct_mine_info(int ww, int wh, int kind, int tx, int ty, int* bytes,
                             int* ctas_per_sm) {
  if (bad_tile(ww, wh, kind, tx, ty)) return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case kHaar:
      return tile_info<kHaar>(ww, wh, tx, ty, bytes, ctas_per_sm);
    case kHaarTilted:
      return tile_info<kHaarTilted>(ww, wh, tx, ty, bytes, ctas_per_sm);
    default:
      return tile_info<kLBP>(ww, wh, tx, ty, bytes, ctas_per_sm);
  }
}

// PR 18's design (warp_kernel), the same contract without the tiles; kept
// for one run beside tile_kernel (utils/time_mine.py, chip_smoke (z)).
extern "C" int cct_mine_warp(const void* table, int rows, const void* lazy, const void* eager,
                             int ww, int wh, int kind, const void* foff, const void* fw,
                             const void* ftilt, const void* fpts, const void* ti,
                             const void* thr, const void* leaf_l, const void* leaf_r,
                             const void* subsets, int n_trees, const void* stage_end,
                             const void* stage_thr, int n_stages, void* out, long long n,
                             void* stream) {
  if (rows < 0 || n < 0 || ww < 2 || wh < 2 || n_trees < 0 || n_stages < 0 || kind < 0 ||
      kind > 2 || n_trees > (1 << (4 * (kLevels + 1))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (rows == 0 || (n + kWarps - 1) / kWarps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* tb = static_cast<const long long*>(table);
  const auto* lz = static_cast<const uint8_t*>(lazy);
  const auto* eg = static_cast<const uint8_t*>(eager);
  const auto* o = static_cast<const int*>(foff);
  const auto* w = static_cast<const int*>(fw);
  const auto* tl = static_cast<const int*>(ftilt);
  const auto* pt = static_cast<const int*>(fpts);
  const auto* i = static_cast<const int*>(ti);
  const auto* th = static_cast<const float*>(thr);
  const auto* ll = static_cast<const float*>(leaf_l);
  const auto* lr = static_cast<const float*>(leaf_r);
  const auto* sb = static_cast<const int*>(subsets);
  const auto* se = static_cast<const int*>(stage_end);
  const auto* sth = static_cast<const double*>(stage_thr);
  auto* ob = static_cast<uint8_t*>(out);
  switch (kind) {
    case kHaar:
      return launch_warp<kHaar>(tb, rows, lz, eg, ww, wh, o, w, tl, pt, i, th, ll, lr, sb,
                                n_trees, se, sth, n_stages, ob, n, st);
    case kHaarTilted:
      return launch_warp<kHaarTilted>(tb, rows, lz, eg, ww, wh, o, w, tl, pt, i, th, ll, lr, sb,
                                      n_trees, se, sth, n_stages, ob, n, st);
    default:
      return launch_warp<kLBP>(tb, rows, lz, eg, ww, wh, o, w, tl, pt, i, th, ll, lr, sb,
                               n_trees, se, sth, n_stages, ob, n, st);
  }
}
