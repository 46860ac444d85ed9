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
// order), the lazy levels' sources in one arena and the eager levels'
// images in another (uint8, row-major, at the row's offset), per used
// feature its record (Haar: 3 rects of 4 corner offsets into the window's
// (wh+1) x (ww+1) integral, integer weights, a tilted flag; LBP: the 16
// points of its 4 x 4 corner grid) and per tree its feature row,
// threshold, two f32 leaves (LBP: 8 subset words), per stage its last
// tree + 1 and its threshold (f64).
//
// Layout: a warp a window, kWarps windows a CTA. The warp
//   1. finds its table row (a binary search over the rows' output
//      offsets) and its window's origin on the level;
//   2. builds the window's pixels in shared memory: a lazy level by
//      build_level's INTER_LINEAR_EXACT integer arithmetic from its source
//      (ops/resize.py:62 _axis_tab_dev: integer round-half-even
//      coefficients, (v + 2^15) >> 16 clamped to 255; the row and column
//      tables first, wh + ww of them), an eager level read from its image;
//   3. builds the int32 sum integral in shared memory (lanes over columns,
//      a column sum down the rows and a warp scan across them), and the
//      tilted integral only for a cascade with tilted features
//      (ops/integral.py:35's row recurrence on rows padded with wh + 1
//      zero columns each side, window-local);
//   4. the norm factor (Haar): the interior's sum and sum of squares in
//      int64, sqrt(area * sq - sum^2) in f64, rounded to f32;
//   5. walks the trees 32 at a time, a lane a tree: its feature value,
//      its leaf, the prefix over the tree axis, then each stage that ends
//      among these 32 trees; the warp stops at the first stage that
//      rejects (the mask cannot change after it).
//
// Bits that must hold (each tested, tests/test_torch_mine.py, and held
// against mine_ref on the card, utils/edges.py::mine_edge_cases):
//   (1) the prefix order. The stage sums are differences of one f64
//       prefix over the tree axis in scan_cumsum's order (train/split.py:
//       62, XLA:CPU's for jnp.cumsum): sequential inside blocks of 16,
//       each block plus the exclusive prefix of the block totals, which
//       is the same scan one level up; block 0 adds +0.0. A running sum
//       in tree order differs once T > 16. The prefix is causal, so the
//       warp carries it: a step's two blocks of 16 are summed
//       sequentially by each lane over shuffles, and one accumulator and
//       one exclusive prefix a level of the recursion (kLevels of them:
//       16^(kLevels + 1) = 65 536 trees) move up as each block completes.
//       The top level's sequential run has no +0.0, ours adds it: the two
//       differ only in the sign of a zero sum, which no compare sees.
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
//       row of its grid and the full rows after it (negreader.py:
//       353-358), one table row a run; empty levels have no row; an empty
//       stage list accepts every window.
//
// Bound: each window's pixels read once and its byte written, beside the
// arithmetic of the trees actually evaluated (chip_smoke counts both); the
// integrals are built per window as the JAX program builds them, so the
// overlapping windows' pixels are read again from L1/L2, not from device
// memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;     // windows a CTA, a warp each
constexpr int kLevels = 3;    // carried levels of the blocked scan above the leaves
constexpr int kBase = 16;     // scan_cumsum's block (SCAN_BASE)
constexpr int kMaxShared = 232448;  // a CTA's dynamic shared memory on sm_90
constexpr double kEps = 1e-5;  // CV_THRESHOLD_EPS

// level table columns (train/mine.py::LEVEL_COLS)
enum Col { kSrcOff, kEager, kSh, kSw, kDh, kDw, kOy, kOx, kNx, kW0, kCount, kOut, kCols };

enum Kind { kHaar = 0, kHaarTilted = 1, kLBP = 2 };

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// _axis_tab_dev for one output coordinate d of an (ssz -> dsz) axis of an
// unpadded source: (idx0, idx1, coefficient of idx1)
__device__ __forceinline__ void axis_tab(int ssz, int dsz, int d, int* out) {
  const long long two = 2LL * dsz;
  const long long num = (2LL * d + 1) * ssz - dsz;
  long long sx = floor_div(num, two);
  const long long rem = num - sx * two;
  const long long a = 128 * rem;  // >= 0
  const long long q = a / dsz;
  const long long r = a - q * dsz;
  long long c = q + ((2 * r > dsz) || (2 * r == dsz && (q & 1)) ? 1 : 0);
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

// ints of shared memory a warp takes
__host__ __device__ __forceinline__ int warp_ints(int wh, int ww, int kind) {
  const int cells = (wh + 1) * (ww + 1);
  int n = 3 * wh + 3 * ww + (wh * ww + 3) / 4 + cells;
  if (kind == kHaarTilted) n += cells + 3 * (ww + 2 * (wh + 1) + 1);
  return n;
}

// the blocked scan's carried state, the same in every lane of the warp
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

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
    mine_kernel(const long long* __restrict__ table, int rows, const uint8_t* __restrict__ lazy,
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
    for (int r = lane; r < wh; r += 32) axis_tab(sh, dh, y0 + r, rtab + 3 * r);
    for (int c = lane; c < ww; c += 32) axis_tab(sw, dw, x0 + c, ctab + 3 * c);
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
int launch(const long long* table, int rows, const uint8_t* lazy, const uint8_t* eager, int ww,
           int wh, const int* foff, const int* fw, const int* ftilt, const int* fpts,
           const int* ti, const float* thr, const float* ll, const float* lr, const int* sub,
           int n_trees, const int* send, const double* sthr, int n_stages, uint8_t* out,
           long long n, cudaStream_t st) {
  const int bytes = kWarps * warp_ints(wh, ww, K) * 4;
  if (bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e =
      cudaFuncSetAttribute(mine_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (n + kWarps - 1) / kWarps;
  mine_kernel<K><<<static_cast<unsigned>(blocks), kWarps * 32, bytes, st>>>(
      table, rows, lazy, eager, ww, wh, foff, fw, ftilt, fpts, ti, thr, ll, lr, sub, n_trees,
      send, sthr, n_stages, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 Haar upright, 1 Haar with tilted features, 2 LBP
extern "C" int cct_mine(const void* table, int rows, const void* lazy, const void* eager,
                        int ww, int wh, int kind, const void* foff, const void* fw,
                        const void* ftilt, const void* fpts, const void* ti, const void* thr,
                        const void* leaf_l, const void* leaf_r, const void* subsets,
                        int n_trees, const void* stage_end, const void* stage_thr,
                        int n_stages, void* out, long long n, void* stream) {
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
      return launch<kHaar>(tb, rows, lz, eg, ww, wh, o, w, tl, pt, i, th, ll, lr, sb, n_trees,
                           se, sth, n_stages, ob, n, st);
    case kHaarTilted:
      return launch<kHaarTilted>(tb, rows, lz, eg, ww, wh, o, w, tl, pt, i, th, ll, lr, sb,
                                 n_trees, se, sth, n_stages, ob, n, st);
    default:
      return launch<kLBP>(tb, rows, lz, eg, ww, wh, o, w, tl, pt, i, th, ll, lr, sb, n_trees,
                          se, sth, n_stages, ob, n, st);
  }
}
