// Best two-class stump split of every feature of a sorted block, for the
// DAB (misclassification) and RAB (Gini) trainers.
//
// Replaces cascadeclassifier_tpu/train/boost.py:258 _ordered_class_split_block
// after its sort and :214 _ordered_class_split_sorted (XLA: the gathers of
// the class weights into each feature's sort order, two cumsums, a reversed
// cummin, the quality and a first argmax). Output per feature: the best
// quality (f64, -inf when no split is valid) and the f32 midpoint threshold.
//
// The f64 prefix sums are added in XLA:CPU's order for jnp.cumsum
// (train/split.py::scan_cumsum): sequential runs from +0.0 within blocks of
// 16 samples, each plus the exclusive prefix of the block totals, which are
// scanned the same way one level up. A position's prefix is its block's own
// sequential sum plus that exclusive prefix.
//
// Bound: device memory. A block of 32 768 features x 3 072 samples reads the
// sorted values (f32) and the sort order (int64) once, 12 B an element
// (0.361 ms at 3.35 TB/s). The f64 work is far below it. The walk is
// latency-bound, so the design keeps its state out of registers and its
// shared memory to a warp's one stage, for as many warps an SM as fit: a
// lane holds no array of its 16 samples' values, prefixes or candidates.
//
// Design:
// - A compact class table. Every caller passes the masked weights of each
//   class, so a sample has at most one non-zero weight, and both are zero
//   where it is masked out. The kernel builds one f64 a sample: the class-0
//   weight, or minus the class-1 weight, or NaN where the mask is false.
//   Adding the other class's +0.0 to a non-negative sum leaves it as it is,
//   so a sample adds its weight to its own class's sum and nothing to the
//   other, with the bits of the two-table scan. 8 B a sample instead of 17,
//   in shared memory when it fits, else read from w0, w1 and mask in global
//   memory (where they stay in L2).
// - A warp is a worker of its own: it takes two features at a time (lanes
//   0-15 and 16-31) and walks their samples in chunks of 256, one level-1
//   block, lane k holding block k of 16. A CTA of 12 warps takes 107 KiB of
//   shared memory with the table of 3 072 samples, at most 80 registers a
//   thread: two CTAs, 24 warps, an SM. A warp's stage in shared memory
//   holds the chunk's sort order and values, copied with cp.async into
//   rows of 16 samples whose 16-byte groups are XOR-swizzled by row, so
//   that each lane reads its row with 16-byte loads and no bank conflicts.
//   Where the samples are contiguous (torch.sort's outputs, the trainer's
//   path) a warp's lanes copy its stage, 16 bytes a copy (an element a copy
//   where the rows are not 16-byte aligned), and no barrier of the CTA is
//   taken after the table is built. Where the features are (a
//   resident (N, B) block) the CTA's threads copy its 24 features' chunk
//   together, adjacent threads along the features, between two barriers.
// - Two passes over a lane's 16 samples. The first gathers each sample's
//   table entry through the sort order, writes it over the order in the
//   stage, and sums the block; the lanes of a feature then exchange their
//   block totals through shared memory (the sequential sum of the totals
//   before each block) and, by ballots and shuffles, the first kept value
//   of the blocks after each. The second walks the 16 samples forward with
//   the prefixes and keeps one pending kept position, judged when the next
//   kept position arrives (the columns are sorted, so its value is the next
//   kept value), without branches; Gini divides only where the quotient may
//   beat the lane's best. A lane's last kept position is judged against the
//   first kept value of the blocks after it; the chunk's last is carried
//   and judged against the first kept value of the next chunk that holds
//   one.
// - Across chunks each feature carries the level-1 prefix, the scan of the
//   chunk totals (levels >= 2) and the carried kept position in shared
//   memory (struct Carry), not in registers.
// - Each lane keeps its first maximum (the higher quality, the lower
//   position on an exact tie); the 16 lanes of a feature merge theirs by
//   shuffles at the feature's end.
// --fmad=false keeps every product and sum rounded on its own, as XLA:CPU
// leaves them; the fmas of the Gini quality are written out.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBase = 16;              // XLA:CPU ReduceWindowRewriter base length
constexpr int kChunk = kBase * kBase;  // 256 samples: one level-1 block
constexpr int kPair = 2;               // features a warp works on at once
constexpr int kWarps = 12;             // warps a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;          // CTAs an SM the registers are capped for
constexpr int kStages = 1;             // stages a warp
constexpr int kMaxLevels = 5;          // 16^6 samples
constexpr int kMaxUpper = kMaxLevels - 2;
constexpr float kTwoFltEps = 2.384185791015625e-07f;  // 2 * FLT_EPSILON
constexpr double kBelow = 1.0 - 0x1p-50;
constexpr unsigned kFull = 0xffffffffu;

// A warp's stage: 32 rows (2 features x 16 blocks) of 16 samples, the sort
// order (8 bytes a sample, then the table entries) and the values.
constexpr int kRows = kPair * kBase;
constexpr int kOrderBytes = kRows * kBase * 8;
constexpr int kStageBytes = kOrderBytes + kRows * kBase * 4;

// Round up to 16 bytes.
__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// The scan of a feature's chunk totals (levels >= 2), kept by one lane.
struct Upper {
  double acc[2][kMaxUpper + 1];  // running sum of the open block at each level
  double ep[2][kMaxUpper + 2];   // ep[l]: prefix of level-(l-1) blocks before the open one
  double out[2];                 // the inclusive prefix of the last chunk total pushed
  int cnt[kMaxUpper + 1];        // members of the open block at each level
};
// A feature's state carried across chunks: the scan of the chunk totals and
// the level-1 prefix (kept by lane 0), the chunk's last kept position (by
// the lane that held it, judged by lane 0 in the next chunk that holds one)
// and the value at position 0.
struct Carry {
  Upper up;
  double c1p[2];  // the level-1 prefix before the chunk
  double cc[2];   // the carried kept position's prefixes, value and position
  float cv;
  int cpos;
  int cpend;      // a kept position is carried
  float v0;
};
// a warp's shared memory: its stages, the block totals exchanged, its two Carrys
constexpr int kWarpBytes =
    kStages * kStageBytes + kRows * 16 + int(align16(kPair * sizeof(Carry)));
constexpr int kCtaBytes = kWarps * kWarpBytes;
static_assert(kWarpBytes % 16 == 0, "16-byte warp areas");

// The compact table of n entries in shared memory.
__host__ __device__ constexpr size_t table_bytes(int n) { return align16(size_t(n) * 8); }

// Byte offsets in a stage of sample m of row r: the 16-byte groups of a row
// are XOR-swizzled by the row, so that 8 lanes reading 8 consecutive rows'
// group g (a quarter-warp's 16-byte loads) hit 8 different bank groups.
__device__ __forceinline__ int off8(int r, int m) {
  return r * 128 + ((((m >> 1) ^ r) & 7) << 4) + ((m & 1) << 3);
}
__device__ __forceinline__ int off4(int r, int m) {
  return kOrderBytes + r * 64 + ((((m >> 2) ^ (r >> 1)) & 3) << 4) + ((m & 3) << 2);
}

// The table entry of a sample: its class-0 weight, minus its class-1 weight
// (which is then non-zero), or NaN where it is masked out.
__device__ __forceinline__ double entry(double w0, double w1, uint8_t kept) {
  return kept ? (w1 != 0.0 ? -w1 : w0) : CUDART_NAN;
}

// cp.async of E bytes (4, 8 or 16); `bytes` of them are read, the rest zeroed.
template <int E>
__device__ __forceinline__ void cp_async(uint8_t* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (E == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(E),
                 "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const float* vs;
  long long vs_si, vs_sf;  // element strides along samples and features
  const long long* order;
  long long o_si, o_sf;
  const double* w0;        // per-sample tables
  const double* w1;
  const uint8_t* mask;
  int n, b, levels;
  bool l1_first;           // Gini: fma(c1, c1, c0^2) on the left
  bool bulk;               // the samples contiguous and 16-byte aligned: 16-byte copies
  bool feat_fast;          // the features contiguous: the CTA copies together (copy_tile)
  double t0, t1;           // the class totals
  double* q_out;
  float* thr_out;
};

// Copies chunk i0 of features f0 and f0 + 1 into a warp's stage (zeros past
// n and past b).
__device__ __forceinline__ void copy_chunk(const Args& a, uint8_t* st, int f0, int i0,
                                           int lane) {
  if (a.bulk) {
#pragma unroll
    for (int t = 0; t < kRows * kBase / 2 / 32; ++t) {  // order: 2 samples a copy
      const int e = lane + 32 * t, fl = e >> 7, i = (e & 127) * 2;
      const int f = f0 + fl, r = fl * kBase + (i >> 4);
      const int left = f < a.b ? min(a.n - (i0 + i), 2) : 0;
      const long long* src = left > 0 ? a.order + f * a.o_sf + i0 + i : a.order;
      cp_async<16>(st + off8(r, i & 15), src, left > 0 ? left * 8 : 0);
    }
#pragma unroll
    for (int t = 0; t < kRows * kBase / 4 / 32; ++t) {  // values: 4 samples a copy
      const int e = lane + 32 * t, fl = e >> 6, i = (e & 63) * 4;
      const int f = f0 + fl, r = fl * kBase + (i >> 4);
      const int left = f < a.b ? min(a.n - (i0 + i), 4) : 0;
      const float* src = left > 0 ? a.vs + f * a.vs_sf + i0 + i : a.vs;
      cp_async<16>(st + off4(r, i & 15), src, left > 0 ? left * 4 : 0);
    }
    return;
  }
  for (int e = lane; e < kRows * kBase; e += 32) {  // an element a copy
    const int fl = e >> 8, i = e & 255;
    const int f = f0 + fl, r = fl * kBase + (i >> 4);
    const bool ok = f < a.b && i0 + i < a.n;
    const long long io = i0 + i;
    cp_async<8>(st + off8(r, i & 15), ok ? a.order + io * a.o_si + f * a.o_sf : a.order,
                ok ? 8 : 0);
    cp_async<4>(st + off4(r, i & 15), ok ? a.vs + io * a.vs_si + f * a.vs_sf : a.vs,
                ok ? 4 : 0);
  }
}

// Where the features are contiguous (a resident (N, B) block): copies
// chunk i0 of the CTA's 2 x kWarps features from F0 on into its warps'
// stages, an element a copy with adjacent threads along the features, so
// that a warp's copies read whole sectors (zeros past n and past b).
__device__ __forceinline__ void copy_tile(const Args& a, uint8_t* area, int F0, int i0) {
  constexpr int kFeats = kWarps * kPair;
  for (int e = threadIdx.x; e < kFeats * kChunk; e += kThreads) {
    const int fl = e % kFeats, i = e / kFeats;
    const int f = F0 + fl, r = fl % kPair * kBase + (i >> 4);
    uint8_t* st = area + size_t(fl / kPair) * kWarpBytes;
    const bool ok = f < a.b && i0 + i < a.n;
    const long long io = i0 + i;
    cp_async<8>(st + off8(r, i & 15), ok ? a.order + io * a.o_si + f : a.order, ok ? 8 : 0);
    cp_async<4>(st + off4(r, i & 15), ok ? a.vs + io * a.vs_si + f : a.vs, ok ? 4 : 0);
  }
}

struct Best {
  double q;
  int pos;
  float v, nx;
  double lim;  // RN(q (1 - 2^-50)), Gini's division bound
};

__device__ __forceinline__ void take(Best& b, double q, int pos, float v, float nx) {
  if (q > b.q || (q == b.q && pos < b.pos)) b = Best{q, pos, v, nx, __dmul_rn(q, kBelow)};
}

// Judges the split after a kept position (class prefixes c0, c1, value v)
// whose next kept value is nx, where ok (a position is pending): if it is
// valid, its quality is taken into the lane's first maximum b. Branch-free
// but for Gini's division, so that the positions of a lane's walk overlap:
// Gini divides only where the quotient may reach b.q (where num <
// RN(b.lim den), num / den < b.q (1 - 2^-51) and rounds below b.q, which
// cannot be the feature's maximum).
template <bool G>
__device__ __forceinline__ void judge(const Args& a, Best& b, bool ok, double c0, double c1,
                                      float v, int pos, float nx) {
  ok = ok && __fadd_rn(v, kTwoFltEps) < nx && isfinite(nx);
  const double r0 = __dsub_rn(a.t0, c0), r1 = __dsub_rn(a.t1, c1);
  if (!G) {
    const double q = fmax(__dadd_rn(c0, r1), __dadd_rn(c1, r0));
    if (ok && (q > b.q || (q == b.q && pos < b.pos))) b = Best{q, pos, v, nx, 0.0};
    return;
  }
  const double tl = __dadd_rn(c0, c1), tr = __dadd_rn(r0, r1);
  // XLA:CPU contracts ((c0^2 + c1^2) tr + (r0^2 + r1^2) tl) / (tl tr) into
  // fma(L, tr, fma(r0, r0, r1^2) tl) with L = fma(c0, c0, c1^2), or
  // fma(c1, c1, c0^2) (train/split.py::gini_l1_first)
  const double left = a.l1_first ? __fma_rn(c1, c1, __dmul_rn(c0, c0))
                                 : __fma_rn(c0, c0, __dmul_rn(c1, c1));
  const double num = __fma_rn(left, tr, __dmul_rn(__fma_rn(r0, r0, __dmul_rn(r1, r1)), tl));
  const double den = __dmul_rn(tl, tr);
  if (ok && tl > 0.0 && tr > 0.0 && !(num < __dmul_rn(b.lim, den)))
    take(b, __ddiv_rn(num, den), pos, v, nx);
}

// Feeds one chunk total of each class to the scan of the chunk totals with
// `levels` block levels; leaves its inclusive prefix in u.out.
__device__ void upper_push(Upper& u, double x0, double x1, int levels) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    double* acc = u.acc[c];
    double* ep = u.ep[c];
    acc[0] = __dadd_rn(u.cnt[0] == 0 ? 0.0 : acc[0], c ? x1 : x0);
    u.out[c] = levels == 0 ? acc[0] : __dadd_rn(acc[0], ep[1]);
    bool carry = levels > 0 && u.cnt[0] == kBase - 1;
    double t = acc[0];
    for (int l = 1; l <= levels && carry; ++l) {
      acc[l] = __dadd_rn(u.cnt[l] == 0 ? 0.0 : acc[l], t);
      ep[l] = l == levels ? acc[l] : __dadd_rn(acc[l], ep[l + 1]);
      t = acc[l];
      carry = l < levels && u.cnt[l] == kBase - 1;
    }
  }
  for (int l = 0; l <= levels; ++l) {
    ++u.cnt[l];
    if (!(l < levels && u.cnt[l] == kBase)) break;
    u.cnt[l] = 0;
  }
}

template <bool G, bool SharedTable>
__global__ void __launch_bounds__(kThreads, kMinBlocks) split_class_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = lane >> 4;  // the feature of the pair
  const int k = lane & 15;     // the block of 16 in the chunk
  const int r = lane;          // the lane's row in the stage
  const int n = a.n;
  const int nch = (n + kChunk - 1) / kChunk;
  const int pairs = (a.b + 1) / kPair;
  const int gw = blockIdx.x * kWarps + warp, nw = gridDim.x * kWarps;
  // with copy_tile every warp of the CTA takes as many items as its first
  // (a warp past the last pair works on features past b)
  const bool coop = kStages == 1 && a.feat_fast;
  const int lead = coop ? blockIdx.x * kWarps : gw;
  const int items = lead < pairs ? ((pairs - 1 - lead) / nw + 1) * nch : 0;

  // the compact table: entry j of sample j, built once a CTA
  uint8_t* area = smem;
  double* tab = reinterpret_cast<double*>(smem);
  if (SharedTable) {
    for (int j = threadIdx.x; j < n; j += kThreads) tab[j] = entry(a.w0[j], a.w1[j], a.mask[j]);
    area = smem + table_bytes(n);
    __syncthreads();
  }
  uint8_t* wa = area + size_t(warp) * kWarpBytes;
  double2* xch = reinterpret_cast<double2*>(wa + kStages * kStageBytes);
  Carry& car = reinterpret_cast<Carry*>(xch + kRows)[half];

  // the item issued next: its chunk and its pair's first feature
  int is_c = 0, is_f0 = gw * kPair;
  auto advance = [&]() {
    if (++is_c == nch) {
      is_c = 0;
      is_f0 += nw * kPair;
    }
  };
  auto issue = [&](int stage) {
    copy_chunk(a, wa + stage * kStageBytes, is_f0, is_c * kChunk, lane);
    advance();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < items) issue(s);
    cp_async_commit();
  }

  int c = 0, f0 = gw * kPair;  // the item computed
  // per lane: its first maximum and the smallest kept value past position 0
  Best best{-CUDART_INF, INT_MAX, 0.f, 0.f, -CUDART_INF};
  float fnext = CUDART_INF_F;

  for (int it = 0; it < items; ++it) {
    if constexpr (kStages == 1) {
      if (coop) {
        __syncthreads();  // every warp is done with its stage
        copy_tile(a, area, is_f0 - warp * kPair, is_c * kChunk);
        advance();
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      } else {
        __syncwarp();  // every lane is done with the stage
        issue(0);
        cp_async_commit();
        cp_async_wait<0>();
      }
    } else {
      // item it has landed; past the barrier every lane is done with item
      // it - 1, whose stage the next copies refill
      cp_async_wait<kStages >= 2 ? kStages - 2 : 0>();
      __syncwarp();
      if (it + kStages - 1 < items) issue((it + kStages - 1) % kStages);
      cp_async_commit();
    }
    uint8_t* st = wa + (it % kStages) * kStageBytes;
    const int f = f0 + half;
    const int ib = c * kChunk + k * kBase;  // the lane's first sample
    const int left = f < a.b ? n - ib : 0;  // samples of the lane's block that exist
    if (c == 0) {
      best = Best{-CUDART_INF, INT_MAX, 0.f, 0.f, -CUDART_INF};
      fnext = CUDART_INF_F;
      if (k == 0) {
        car.up = Upper{};
        car.c1p[0] = car.c1p[1] = 0.0;
        car.cpend = 0;
      }
    }
    __syncwarp();
    if (c == 0 && k == 0) car.v0 = *reinterpret_cast<const float*>(st + off4(r, 0));

    // pass 1: the table entries through the sort order, written over it,
    // and the block's sequential sums from +0.0
    double s0 = 0.0, s1 = 0.0;
    unsigned kbits = 0;
#pragma unroll
    for (int q = 0; q < kBase / 2; ++q) {
      double2* p = reinterpret_cast<double2*>(st + off8(r, 2 * q));
      const longlong2 o = *reinterpret_cast<const longlong2*>(p);
      double e[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = static_cast<int>(h ? o.y : o.x);  // the order's entries are < n
        const bool here = 2 * q + h < left;
        if (SharedTable)
          e[h] = here ? tab[j] : CUDART_NAN;
        else
          e[h] = here ? entry(__ldg(a.w0 + j), __ldg(a.w1 + j), __ldg(a.mask + j)) : CUDART_NAN;
        if (e[h] >= 0.0)
          s0 = __dadd_rn(s0, e[h]);
        else if (e[h] < 0.0)
          s1 = __dsub_rn(s1, e[h]);
        if (e[h] == e[h]) kbits |= 1u << (2 * q + h);
      }
      *p = make_double2(e[0], e[1]);
    }
    const float fk = kbits ? *reinterpret_cast<const float*>(st + off4(r, __ffs(kbits) - 1))
                           : CUDART_INF_F;  // the block's first kept value

    // the sequential sum of the feature's block totals before this block
    xch[lane] = make_double2(s0, s1);
    __syncwarp();
    double x0 = 0.0, x1 = 0.0;
#pragma unroll
    for (int m = 0; m < kBase - 1; ++m) {
      if (m < k) {
        const double2 t = xch[half * kBase + m];
        x0 = __dadd_rn(x0, t.x);
        x1 = __dadd_rn(x1, t.y);
      }
    }
    // the chunk's totals: block 15's exclusive sum plus its own total
    const double sw0 = __shfl_sync(kFull, __dadd_rn(x0, s0), kBase - 1, kBase);
    const double sw1 = __shfl_sync(kFull, __dadd_rn(x1, s1), kBase - 1, kBase);
    // the exclusive prefix of this block: the level-1 prefix before the
    // chunk for block 0 (+0.0 in chunk 0), else the sum of the blocks
    // before it plus the scan of the chunk totals before this chunk
    const double E0 = k == 0 ? car.c1p[0] : __dadd_rn(x0, car.up.out[0]);
    const double E1 = k == 0 ? car.c1p[1] : __dadd_rn(x1, car.up.out[1]);

    // the blocks of the feature that hold a kept sample: the first kept
    // value after this block, the chunk's first kept value and last block
    const unsigned seg = (__ballot_sync(kFull, kbits != 0) >> (half * kBase)) & 0xffffu;
    const unsigned after = seg & ~((2u << k) - 1u);
    const float g = __shfl_sync(kFull, fk, half * kBase + (after ? __ffs(after) - 1 : k));
    const float cf = __shfl_sync(kFull, fk, half * kBase + (seg ? __ffs(seg) - 1 : 0));
    if (seg && k == 0)
      judge<G>(a, best, car.cpend, car.cc[0], car.cc[1], car.cv, car.cpos, cf);

    // pass 2: the walk, with one pending kept position
    s0 = s1 = 0.0;
    bool pend = false;
    double pc0 = 0.0, pc1 = 0.0;
    float pv = 0.f;
    int ppos = 0;
#pragma unroll
    for (int q = 0; q < kBase / 4; ++q) {
      const float4 vv = *reinterpret_cast<const float4*>(st + off4(r, 4 * q));
      const double2 ea = *reinterpret_cast<const double2*>(st + off8(r, 4 * q));
      const double2 eb = *reinterpret_cast<const double2*>(st + off8(r, 4 * q + 2));
      const float vq[4] = {vv.x, vv.y, vv.z, vv.w};
      const double eq[4] = {ea.x, ea.y, eb.x, eb.y};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const double e = eq[h];
        if (e >= 0.0)
          s0 = __dadd_rn(s0, e);
        else if (e < 0.0)
          s1 = __dsub_rn(s1, e);
        const bool kept = e == e;
        judge<G>(a, best, kept && pend, pc0, pc1, pv, ppos, vq[h]);
        if (kept) {
          const int pos = ib + 4 * q + h;
          pend = true;
          pc0 = __dadd_rn(s0, E0);
          pc1 = __dadd_rn(s1, E1);
          pv = vq[h];
          ppos = pos;
          if (pos > 0) fnext = fminf(fnext, vq[h]);
        }
      }
    }
    if (after) judge<G>(a, best, pend, pc0, pc1, pv, ppos, g);

    __syncwarp();  // every lane has read the chunk's carried state
    if (seg && k == 31 - __clz(seg)) {  // carry the chunk's last kept position
      car.cc[0] = pc0;
      car.cc[1] = pc1;
      car.cv = pv;
      car.cpos = ppos;
      car.cpend = 1;
    }
    if (nch > 1 && k == 0) {  // carry the upper levels to the next chunk
      car.c1p[0] = __dadd_rn(sw0, car.up.out[0]);
      car.c1p[1] = __dadd_rn(sw1, car.up.out[1]);
      upper_push(car.up, sw0, sw1, a.levels - 2);
    }

    if (c == nch - 1) {  // merge the feature's 16 lanes: the first maximum
#pragma unroll
      for (int off = kBase / 2; off > 0; off >>= 1) {
        const double oq = __shfl_xor_sync(kFull, best.q, off, kBase);
        const int op = __shfl_xor_sync(kFull, best.pos, off, kBase);
        const float ov = __shfl_xor_sync(kFull, best.v, off, kBase);
        const float on = __shfl_xor_sync(kFull, best.nx, off, kBase);
        take(best, oq, op, ov, on);
        fnext = fminf(fnext, __shfl_xor_sync(kFull, fnext, off, kBase));
      }
      if (k == 0 && f < a.b) {
        if (best.q == -CUDART_INF) {  // no valid split: position 0, as the first max of -inf
          best.v = car.v0;
          best.nx = fnext;
        }
        a.q_out[f] = best.q;
        a.thr_out[f] = __fmul_rn(__fadd_rn(best.v, best.nx), 0.5f);
      }
    }
    if (++c == nch) {
      c = 0;
      f0 += nw * kPair;
    }
  }
  cp_async_wait<0>();
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Whether n samples' table fits in shared memory beside the warps' areas.
bool table_in_shared(int n) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return table_bytes(n) + kCtaBytes <= static_cast<size_t>(optin);
}

template <bool G, bool S>
cudaError_t configure(int n, size_t* smem, int* per_sm) {
  *smem = (S ? table_bytes(n) : 0) + kCtaBytes;
  cudaError_t err = cudaFuncSetAttribute(split_class_kernel<G, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, split_class_kernel<G, S>,
                                                       kThreads, *smem);
}

template <bool G, bool S>
int launch(const Args& a, cudaStream_t stream) {
  size_t smem = 0;
  int per_sm = 0;
  cudaError_t err = configure<G, S>(a.n, &smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ctas = ((a.b + 1) / kPair + kWarps - 1) / kWarps;
  const int grid = ctas < sm_count() * per_sm ? ctas : sm_count() * per_sm;
  split_class_kernel<G, S><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vs (f32) and order (int64), each (n, b) with element strides (along
// samples, along features), one of them 1; w0, w1 (f64) the masked weights
// of the class-0 and the class-1 samples, n each, at most one of them
// non-zero a sample and both zero where mask (bytes 0/1) is 0; t0, t1 their
// totals; gini 0 (misclassification) or 1. Returns cudaGetLastError() after
// the launch.
extern "C" int cct_split_class(const void* vs, long long vs_si, long long vs_sf,
                               const void* order, long long o_si, long long o_sf, const void* w0,
                               const void* w1, const void* mask, int n, int b, int levels,
                               int gini, double t0, double t1, void* q, void* thr, void* stream) {
  if (n <= 0 || b < 0 || levels < 0 || levels > kMaxLevels || (gini != 0 && gini != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaGetLastError());
  Args a{};
  a.vs = static_cast<const float*>(vs);
  a.vs_si = vs_si;
  a.vs_sf = vs_sf;
  a.order = static_cast<const long long*>(order);
  a.o_si = o_si;
  a.o_sf = o_sf;
  a.w0 = static_cast<const double*>(w0);
  a.w1 = static_cast<const double*>(w1);
  a.mask = static_cast<const uint8_t*>(mask);
  a.n = n;
  a.b = b;
  a.levels = levels;
  a.l1_first = n > kChunk && n % kBase != 0;  // train/split.py::gini_l1_first
  a.bulk = vs_si == 1 && o_si == 1 && (b == 1 || (vs_sf % 4 == 0 && o_sf % 2 == 0)) &&
           (reinterpret_cast<uintptr_t>(vs) & 15) == 0 &&
           (reinterpret_cast<uintptr_t>(order) & 15) == 0;
  a.feat_fast = vs_sf == 1 && o_sf == 1;
  a.t0 = t0;
  a.t1 = t1;
  a.q_out = static_cast<double*>(q);
  a.thr_out = static_cast<float*>(thr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_in_shared(n))
    return gini ? launch<true, true>(a, s) : launch<false, true>(a, s);
  return gini ? launch<true, false>(a, s) : launch<false, false>(a, s);
}

// For n samples and a policy: the CTAs an SM holds, and whether the table
// goes to shared memory (1) or stays in global memory (0).
extern "C" int cct_split_class_info(int n, int gini, int* ctas_per_sm, int* shared_table) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const bool s = table_in_shared(n);
  *shared_table = s;
  const cudaError_t err = s ? (gini ? configure<true, true>(n, &smem, ctas_per_sm)
                                    : configure<false, true>(n, &smem, ctas_per_sm))
                            : (gini ? configure<true, false>(n, &smem, ctas_per_sm)
                                    : configure<false, false>(n, &smem, ctas_per_sm));
  return static_cast<int>(err);
}

// The largest sample count whose table goes to shared memory.
extern "C" int cct_split_class_shared_max(int* n_max) {
  int lo = 0, hi = 1 << 24;
  while (lo < hi) {  // the largest n in [0, hi) with its table in shared memory
    const int mid = lo + (hi - lo + 1) / 2;
    if (table_in_shared(mid)) lo = mid; else hi = mid - 1;
  }
  *n_max = lo;
  return static_cast<int>(cudaGetLastError());
}
