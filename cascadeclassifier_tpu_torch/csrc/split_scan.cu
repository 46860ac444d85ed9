// Best stump split of every feature of a sorted block, for the GAB and LB
// trainers (the two-class split of DAB and RAB is split_class.cu).
//
// Replaces cascadeclassifier_tpu/train/boost.py:129 _ordered_split_block and
// :74 _ordered_split_sorted (XLA: gathers of the per-sample weights into each
// feature's sort order, cumsum over the sorted axis, a reversed cummin, the
// quality and a first argmax). Output per feature: the best quality (f64,
// -inf when no split is valid) and the f32 midpoint threshold.
//
// The f64 prefix sums are added in the order XLA:CPU adds them for
// jnp.cumsum (the JAX package's arithmetic, which the trainer is held to bit
// for bit; train/split.py::scan_cumsum): sequential runs from +0.0 within
// blocks of 16 samples, each plus the exclusive prefix of the block totals,
// which are scanned the same way one level up; the top level is one
// sequential run. The level-0 blocks are independent, so one thread takes
// one (feature, block of 16) and the adds stay the same adds.
//
// Bound: device memory. A block of 32 768 features x 3 072 samples reads, in
// the gathered form, the sorted values (f32) and the sort order (int64) once,
// 12 B an element (0.361 ms at 3.35 TB/s); in the array form values, masked
// weights, weight x responses (f64) and kept bytes, 21 B an element (0.631 ms).
// The f64 work (two scans, the quality at valid positions) is far below it.
//
// Design:
// - A CTA of 256 threads owns a tile of 16 features and walks its tiles
//   persistently (one grid of SMs x CTAs an SM). It streams each tile's
//   samples in chunks of 256, one level-1 block, through a ring of stages in
//   shared memory filled with cp.async, zero-filled past n and past b: 16
//   bytes a copy along samples where that stride is 1 (torch.sort's (B, N)
//   outputs), else one element a copy with adjacent threads along features
//   (a resident (N, B) block). A block of 16 samples is a row of the ring,
//   which its thread reads with 16-byte loads.
// - Gathered form: the per-sample tables (masked weight, masked weight x
//   response, mask; 17 B a sample) are loaded into shared memory once per
//   CTA when they fit beside the ring, else read from global memory, where
//   they stay in L2. No (N, B) f64 array exists in device memory.
// - Within a chunk, thread (feature, k) sums its 16 samples sequentially from
//   +0.0 (its 16 inclusive prefixes and its block total), gets the sequential
//   sum of the totals of blocks 0..k-1 from the feature's 16 totals (its
//   warp exchanges them through shared memory), and adds the exclusive
//   prefix of its block. Across chunks each feature
//   carries the upper levels (levels >= 2): the level-1 prefix at the end of
//   the chunk and the scan of the chunk totals (the Scan struct below, fed
//   one chunk total at a time).
// - The next kept value after a position is the smallest kept value after
//   it (the column is sorted): a suffix min within the thread's 16 samples
//   plus that of the blocks after it. The chunk's last kept position has its
//   next kept value in a later chunk: it is carried, and judged against the
//   first kept value of the next chunk that holds one.
// - Each thread keeps its best (quality, position); the 16 threads of a
//   feature merge them by shuffles: the higher quality wins, the lower
//   position wins a tie (exact compares), which is the first maximum.
// --fmad=false keeps every other product and sum rounded on its own, as
// XLA:CPU leaves them; the one fma of the quality is written out.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBase = 16;                  // XLA:CPU ReduceWindowRewriter base length
constexpr int kChunk = kBase * kBase;      // 256 samples: one level-1 block
constexpr int kTile = 16;                  // features a CTA
constexpr int kThreads = kTile * kBase;    // one thread a (feature, level-0 block)
constexpr int kMaxLevels = 5;              // 16^6 samples
constexpr int kMaxUpper = kMaxLevels - 2;  // levels carried across chunks
constexpr float kTwoFltEps = 2.384185791015625e-07f;  // 2 * FLT_EPSILON
constexpr unsigned kFull = 0xffffffffu;

// The ring keeps a block of 16 samples as a row, which its thread reads with
// 16-byte loads; row pitches of 80 and 144 bytes (5 and 9 times 16) put the
// rows of 8 neighbouring threads in 8 different 16-byte bank groups, and the
// feature pitches spread scalar writes along features over the banks.
// (elements: row pitch, feature pitch)
constexpr int kRow4 = 20, kFeat4 = kBase * kRow4 + 4;    // f32 values
constexpr int kRow8 = 18, kFeat8 = kBase * kRow8 + 2;    // int64 order, f64 ws and rs
constexpr int kRow1 = 16, kFeat1 = kBase * kRow1 + 16;   // kept bytes
constexpr int kBytes4 = kTile * kFeat4 * 4;
constexpr int kBytes8 = kTile * kFeat8 * 8;
constexpr int kBytes1 = kTile * kFeat1;
constexpr int kStages = 2;
// the feature's block totals and smallest kept values, exchanged in a chunk
constexpr int kXchBytes = kThreads * (16 + 4);

enum Policy { kArray = 0, kGatherShared = 1, kGatherGlobal = 2 };

template <int P>
struct Layout {
  // one ring stage: values, then the sort order (gathered) or ws, rs and
  // the kept bytes (array)
  static constexpr int kStageBytes = P == kArray ? kBytes4 + 2 * kBytes8 + kBytes1
                                                 : kBytes4 + kBytes8;
  static constexpr int kBytes = kStages * kStageBytes + kXchBytes;
};
static_assert(kBytes4 % 16 == 0 && kBytes8 % 16 == 0 && kBytes1 % 16 == 0, "16-byte stages");

// Round up to 16 bytes.
__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared tables of n entries: (masked weight, masked weight x response)
// pairs, then the mask bytes.
__host__ __device__ constexpr size_t table_bytes(int n) { return align16(size_t(n) * 17); }

struct Scan {
  double acc[kMaxUpper + 1];  // running sum of the open block at each level
  double ep[kMaxUpper + 2];   // ep[l]: prefix of level-(l-1) blocks before the open one
};

// Adds x (level 0 of this scan) and returns its inclusive prefix; carries
// closed blocks up. cnt[l] counts the open block's members at level l.
__device__ __forceinline__ double scan_push(Scan& s, const int* cnt, double x, int levels) {
  s.acc[0] = __dadd_rn(cnt[0] == 0 ? 0.0 : s.acc[0], x);
  const double p = levels == 0 ? s.acc[0] : __dadd_rn(s.acc[0], s.ep[1]);
  bool carry = levels > 0 && cnt[0] == kBase - 1;
  double t = s.acc[0];
#pragma unroll
  for (int l = 1; l <= kMaxUpper; ++l) {
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
  for (int l = 0; l <= kMaxUpper; ++l) {
    if (carry && l <= levels) {
      ++cnt[l];
      carry = l < levels && cnt[l] == kBase;
      if (carry) cnt[l] = 0;
    }
  }
}

// cp.async of E bytes (4, 8 or 16); `bytes` of them are read, the rest zeroed.
template <int E>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
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
  const void* a1;          // ws (array) or order (gathered)
  long long a1_si, a1_sf;
  const double* rs;        // array form: rs and kept, with the strides of ws
  const uint8_t* kept;
  const double* wm;        // gathered: per-sample tables
  const double* rm;
  const uint8_t* mask;
  int n, b, levels;
  double total_w, total_r;
  double* q_out;
  float* thr_out;
};

// Copies the tile's (features f0.., samples i0..) elements of one input,
// E bytes each, into a ring stage (zeros past n and past b). Along samples
// with 16-byte copies where that stride is 1 and the features' rows are
// 16-byte aligned; else one element a copy, adjacent threads along whichever
// stride is 1.
template <int E>
__device__ __forceinline__ void fill(uint8_t* dst, const void* src, long long si, long long sf,
                                     int f0, int i0, int n, int b) {
  constexpr int kVec = 16 / E;
  constexpr int kRow = E == 4 ? kRow4 : kRow8;
  constexpr int kFeat = E == 4 ? kFeat4 : kFeat8;
  const uint8_t* g = static_cast<const uint8_t*>(src);
  if (si == 1 && sf % kVec == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int e = threadIdx.x; e < kTile * kChunk / kVec; e += kThreads) {
      const int fl = e / (kChunk / kVec), il = e % (kChunk / kVec) * kVec;
      const int f = f0 + fl, i = i0 + il;
      const int left = f < b ? min(n - i, kVec) : 0;
      const long long off = left > 0 ? (i + f * sf) * E : 0;
      cp_async<16>(dst + (fl * kFeat + (il >> 4) * kRow + (il & 15)) * E, g + off,
                   left > 0 ? left * E : 0);
    }
    return;
  }
  const bool feat_fast = sf == 1;
  for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
    const int fl = feat_fast ? e % kTile : e / kChunk;
    const int il = feat_fast ? e / kTile : e % kChunk;
    const int f = f0 + fl, i = i0 + il;
    const bool ok = f < b && i < n;
    const long long off = ok ? (i * si + f * sf) * E : 0;
    cp_async<E>(dst + (fl * kFeat + (il >> 4) * kRow + (il & 15)) * E, g + off, ok ? E : 0);
  }
}

template <int P>
__device__ __forceinline__ void issue(const Args& a, uint8_t* ring, int stage, int f0, int i0) {
  uint8_t* base = ring + size_t(stage) * Layout<P>::kStageBytes;
  fill<4>(base, a.vs, a.vs_si, a.vs_sf, f0, i0, a.n, a.b);
  fill<8>(base + kBytes4, a.a1, a.a1_si, a.a1_sf, f0, i0, a.n, a.b);
  if (P == kArray) {
    fill<8>(base + kBytes4 + kBytes8, a.rs, a.a1_si, a.a1_sf, f0, i0, a.n, a.b);
    uint8_t* sk = base + kBytes4 + 2 * kBytes8;
    for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {  // bytes: plain loads
      const int fl = e % kTile, il = e / kTile;
      const int f = f0 + fl, i = i0 + il;
      const bool ok = f < a.b && i < a.n;
      sk[fl * kFeat1 + (il >> 4) * kRow1 + (il & 15)] =
          ok ? a.kept[i * a.a1_si + f * a.a1_sf] : 0;
    }
  }
}

struct Best {
  double q;
  int pos;
  float v, nx;
};

__device__ __forceinline__ void take(Best& b, double q, int pos, float v, float nx) {
  if (q > b.q || (q == b.q && pos < b.pos)) {
    b.q = q;
    b.pos = pos;
    b.v = v;
    b.nx = nx;
  }
}

// The quality of the split after a position judged here (its next kept
// value nx), or -inf where no split is valid; branch-free, so that the 16
// positions of a thread run side by side. lw, lr: the prefixes of the two
// tables.
__device__ __forceinline__ double quality(const Args& a, bool judged, float v, float nx,
                                          double lw, double lr) {
  const double rw = __dsub_rn(a.total_w, lw);
  const bool ok = judged && __fadd_rn(v, kTwoFltEps) < nx && isfinite(nx) && lw > 0.0 &&
                  rw > 0.0;
  const double rr = __dsub_rn(a.total_r, lr);
  // XLA:CPU contracts lr*lr*rw + rr*rr*lw into one fma: of rr*rr*lw when the
  // scan has block levels, of lr*lr*rw when it has none
  const double sa = __dmul_rn(lr, lr), sc = __dmul_rn(rr, rr);
  const double num = a.levels > 0 ? __fma_rn(sc, lw, __dmul_rn(sa, rw))
                                  : __fma_rn(sa, rw, __dmul_rn(sc, lw));
  const double q = __ddiv_rn(ok ? num : 0.0, ok ? __dmul_rn(lw, rw) : 1.0);
  return ok ? q : -CUDART_INF;
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1) split_scan_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int fl = tid / kBase;  // feature in the tile: lanes 0-15 and 16-31 of a warp
  const int k = tid % kBase;   // level-0 block in the chunk
  const int n = a.n;
  const int nch = (n + kChunk - 1) / kChunk;
  const int ntiles = (a.b + kTile - 1) / kTile;
  const int my_tiles = blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int items = my_tiles * nch;

  uint8_t* ring = smem;
  // shared tables: (wm, rm) pairs, then the mask bytes; entry n is (0, 0,
  // not kept), which the samples past n (XLA's zero padding) gather
  const double2* tab = nullptr;
  const uint8_t* tmask = nullptr;
  if (P == kGatherShared) {
    double2* swr = reinterpret_cast<double2*>(smem);
    uint8_t* smask = reinterpret_cast<uint8_t*>(swr + n + 1);
    for (int j = tid; j <= n; j += kThreads) {
      swr[j] = j < n ? make_double2(a.wm[j], a.rm[j]) : make_double2(0.0, 0.0);
      smask[j] = j < n ? a.mask[j] : 0;
    }
    tab = swr;
    tmask = smask;
    ring = smem + table_bytes(n + 1);
    __syncthreads();
  }
  double2* xwr = reinterpret_cast<double2*>(ring + kStages * Layout<P>::kStageBytes);
  float* xfk = reinterpret_cast<float*>(xwr + kThreads);
  constexpr int S = kStages;
  // the next item to copy: its chunk and its tile's first feature
  int is_c = 0, is_f0 = blockIdx.x * kTile;
  auto issue_next = [&](int stage) {
    issue<P>(a, ring, stage, is_f0, is_c * kChunk);
    if (++is_c == nch) {
      is_c = 0;
      is_f0 += gridDim.x * kTile;
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < items) issue_next(s);
    cp_async_commit();
  }
  int c = 0, f0 = blockIdx.x * kTile;  // the item computed

  // per-feature state carried across chunks (every thread of the feature
  // holds the same copy; the pending split is judged by thread k = 0)
  double c1w = 0.0, c1r = 0.0, e2w = 0.0, e2r = 0.0;
  Scan uw, ur;
  int ucnt[kMaxUpper + 1];
  Best best;
  float fnext = CUDART_INF_F, v0 = 0.f;
  bool pend = false;
  float pv = 0.f;
  double plw = 0.0, plr = 0.0;
  int ppos = 0;
  const int upper = a.levels - 2;

  for (int it = 0; it < items; ++it) {
    // item it has landed; past the barrier every thread is done with item
    // it - 1, whose stage the next copies refill
    cp_async_wait<S - 2>();
    __syncthreads();
    if (it + S - 1 < items) issue_next((it + S - 1) % S);
    cp_async_commit();

    const int f = f0 + fl;
    const int i0 = c * kChunk;
    const int ib = i0 + k * kBase;
    if (c == 0) {
      c1w = c1r = e2w = e2r = 0.0;
#pragma unroll
      for (int l = 0; l <= kMaxUpper; ++l) {
        uw.acc[l] = ur.acc[l] = 0.0;
        ucnt[l] = 0;
      }
#pragma unroll
      for (int l = 0; l <= kMaxUpper + 1; ++l) uw.ep[l] = ur.ep[l] = 0.0;
      best = Best{-CUDART_INF, INT_MAX, 0.f, 0.f};
      fnext = CUDART_INF_F;
      pend = false;
    }

    // this thread's row of 16 samples, read with 16-byte loads
    const uint8_t* base = ring + size_t(it % S) * Layout<P>::kStageBytes;
    const float4* vrow =
        reinterpret_cast<const float4*>(base) + (fl * kFeat4 + k * kRow4) / 4;
    const uint8_t* row8 = base + kBytes4 + size_t(fl * kFeat8 + k * kRow8) * 8;
    float v[kBase];
    double lw[kBase], lr[kBase];
    unsigned kbits = 0;
#pragma unroll
    for (int q = 0; q < kBase / 4; ++q) {
      const float4 t = vrow[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
    if (P == kArray) {
      const uint4 kb = *reinterpret_cast<const uint4*>(base + kBytes4 + 2 * kBytes8 +
                                                       fl * kFeat1 + k * kRow1);
      const unsigned words[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int q = 0; q < kBase / 2; ++q) {
        const double2 tw = reinterpret_cast<const double2*>(row8)[q];
        const double2 tr = reinterpret_cast<const double2*>(row8 + kBytes8)[q];
        lw[2 * q] = tw.x;
        lw[2 * q + 1] = tw.y;
        lr[2 * q] = tr.x;
        lr[2 * q + 1] = tr.y;
      }
#pragma unroll
      for (int m = 0; m < kBase; ++m)
        if ((words[m / 4] >> (8 * (m % 4))) & 0xffu) kbits |= 1u << m;
    } else {  // gather the tables through the sort order
      // bit m: sample ib + m exists (the array form's ring holds zeros
      // past the block, XLA's padding; here the order is redirected)
      const int left = f < a.b ? n - ib : 0;
      const unsigned in = left >= kBase ? 0xffffu : left > 0 ? (1u << left) - 1 : 0u;
#pragma unroll
      for (int q = 0; q < kBase / 2; ++q) {
        const longlong2 o = reinterpret_cast<const longlong2*>(row8)[q];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 2 * q + h;
          const bool here = (in >> m) & 1u;
          const int j = static_cast<int>(h ? o.y : o.x);  // the order's entries are < n
          if (P == kGatherShared) {
            const double2 t = tab[here ? j : n];
            lw[m] = t.x;
            lr[m] = t.y;
            if (tmask[here ? j : n]) kbits |= 1u << m;
          } else {
            lw[m] = here ? __ldg(a.wm + j) : 0.0;
            lr[m] = here ? __ldg(a.rm + j) : 0.0;
            if (here && __ldg(a.mask + j)) kbits |= 1u << m;
          }
        }
      }
    }
    double pw = 0.0, pr = 0.0;
    float fk = CUDART_INF_F;  // smallest kept value of this block
#pragma unroll
    for (int m = 0; m < kBase; ++m) {
      pw = __dadd_rn(pw, lw[m]);
      pr = __dadd_rn(pr, lr[m]);
      lw[m] = pw;
      lr[m] = pr;
      if ((kbits >> m) & 1u) fk = fminf(fk, v[m]);
    }
    if (c == 0 && k == 0) v0 = v[0];

    // the sequential sum of the block totals before this block, the chunk's
    // total, and the smallest kept value of the blocks after this one
    xwr[tid] = make_double2(pw, pr);
    xfk[tid] = fk;
    __syncwarp();
    const double2* fwr = xwr + fl * kBase;
    float fks[kBase];
#pragma unroll
    for (int q = 0; q < kBase / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(xfk + fl * kBase)[q];
      fks[4 * q] = t.x;
      fks[4 * q + 1] = t.y;
      fks[4 * q + 2] = t.z;
      fks[4 * q + 3] = t.w;
    }
    double xw_ex = 0.0, xr_ex = 0.0;
    float g = CUDART_INF_F, cf = CUDART_INF_F;
#pragma unroll
    for (int m = 0; m < kBase - 1; ++m) {
      if (m < k) {
        const double2 t = fwr[m];
        xw_ex = __dadd_rn(xw_ex, t.x);
        xr_ex = __dadd_rn(xr_ex, t.y);
      }
    }
#pragma unroll
    for (int m = 0; m < kBase; ++m) {
      if (m > k) g = fminf(g, fks[m]);
      cf = fminf(cf, fks[m]);
    }
    // the chunk's total: block 15's exclusive sum plus its own total
    const double sw = __dadd_rn(__shfl_sync(kFull, xw_ex, kBase - 1, kBase),
                                __shfl_sync(kFull, pw, kBase - 1, kBase));
    const double sr = __dadd_rn(__shfl_sync(kFull, xr_ex, kBase - 1, kBase),
                                __shfl_sync(kFull, pr, kBase - 1, kBase));
    if (a.levels > 0) {
      double ew, er;
      if (k == 0) {  // the level-1 prefix before this chunk (+0.0 in chunk 0)
        ew = c1w;
        er = c1r;
      } else if (a.levels == 1) {  // the top level: one sequential run
        ew = xw_ex;
        er = xr_ex;
      } else {
        ew = __dadd_rn(xw_ex, e2w);
        er = __dadd_rn(xr_ex, e2r);
      }
#pragma unroll
      for (int m = 0; m < kBase; ++m) {
        lw[m] = __dadd_rn(lw[m], ew);
        lr[m] = __dadd_rn(lr[m], er);
      }
    }

    const unsigned seg = (__ballot_sync(kFull, kbits != 0) >> (tid & 16)) & 0xffffu;
    // the next kept value after each position: a suffix min over this
    // thread's samples from that of the blocks after it. A kept position
    // whose next kept value lies in this chunk is judged here; the chunk's
    // last kept position is carried.
    float nxa[kBase];
    unsigned judged = 0;
    float nx = g;
    bool has_next = (seg >> (k + 1)) != 0;
    float lv = 0.f;
    double llw = 0.0, llr = 0.0;
    int lpos = 0;
#pragma unroll
    for (int m = kBase - 1; m >= 0; --m) {
      nxa[m] = nx;
      if ((kbits >> m) & 1u) {
        if (has_next) {
          judged |= 1u << m;
        } else {
          lv = v[m];
          llw = lw[m];
          llr = lr[m];
          lpos = ib + m;
        }
        nx = fminf(nx, v[m]);
        has_next = true;
        if (ib + m > 0) fnext = fminf(fnext, v[m]);
      }
    }
    // the first maximum of the 16, by a tree of exact compares
    Best t[kBase];
#pragma unroll
    for (int m = 0; m < kBase; ++m)
      t[m] = Best{quality(a, (judged >> m) & 1u, v[m], nxa[m], lw[m], lr[m]), ib + m, v[m],
                  nxa[m]};
#pragma unroll
    for (int w = 1; w < kBase; w *= 2)
#pragma unroll
      for (int m = 0; m < kBase; m += 2 * w) take(t[m], t[m + w].q, t[m + w].pos, t[m + w].v,
                                                   t[m + w].nx);
    take(best, t[0].q, t[0].pos, t[0].v, t[0].nx);
    const int last = seg ? 31 - __clz(seg) : 0;
    lv = __shfl_sync(kFull, lv, last, kBase);
    llw = __shfl_sync(kFull, llw, last, kBase);
    llr = __shfl_sync(kFull, llr, last, kBase);
    lpos = __shfl_sync(kFull, lpos, last, kBase);
    if (seg) {
      if (pend && k == 0) take(best, quality(a, true, pv, cf, plw, plr), ppos, pv, cf);
      pend = true;
      pv = lv;
      plw = llw;
      plr = llr;
      ppos = lpos;
    }

    if (a.levels >= 2) {  // carry the upper levels to the next chunk
      c1w = __dadd_rn(sw, e2w);
      c1r = __dadd_rn(sr, e2r);
      e2w = scan_push(uw, ucnt, sw, upper);
      e2r = scan_push(ur, ucnt, sr, upper);
      count_push(ucnt, upper);
    }

    if (c == nch - 1) {  // merge the feature's 16 threads: the first maximum
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
          best.v = v0;
          best.nx = fnext;
        }
        a.q_out[f] = best.q;
        a.thr_out[f] = __fmul_rn(__fadd_rn(best.v, best.nx), 0.5f);
      }
    }
    if (++c == nch) {
      c = 0;
      f0 += gridDim.x * kTile;
    }
  }
  cp_async_wait<0>();
}

template <int P>
int launch(const Args& a, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const size_t smem = (P == kGatherShared ? table_bytes(a.n + 1) : 0) + Layout<P>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(split_scan_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, split_scan_kernel<P>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ntiles = (a.b + kTile - 1) / kTile;
  const int grid = ntiles < sms * per_sm ? ntiles : sms * per_sm;
  split_scan_kernel<P><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args base_args(const void* vs, int n, int b, int levels, double total_w, double total_r,
               void* q, void* thr) {
  Args a{};
  a.vs = static_cast<const float*>(vs);
  a.n = n;
  a.b = b;
  a.levels = levels;
  a.total_w = total_w;
  a.total_r = total_r;
  a.q_out = static_cast<double*>(q);
  a.thr_out = static_cast<float*>(thr);
  return a;
}

bool bad_shape(int n, int b, int levels) {
  return n <= 0 || b < 0 || levels < 0 || levels > kMaxLevels;
}

}  // namespace

// Array form: vs (f32), ws, rs (f64) and kept (bytes 0/1), each (n, b)
// sample-major and contiguous. Returns cudaGetLastError() after the launch.
extern "C" int cct_split_scan(const void* vs, const void* ws, const void* rs, const void* kept,
                              int n, int b, int levels, double total_w, double total_r,
                              void* q, void* thr, void* stream) {
  if (bad_shape(n, b, levels)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaGetLastError());
  Args a = base_args(vs, n, b, levels, total_w, total_r, q, thr);
  a.vs_si = a.a1_si = b;
  a.vs_sf = a.a1_sf = 1;
  a.a1 = ws;
  a.rs = static_cast<const double*>(rs);
  a.kept = static_cast<const uint8_t*>(kept);
  return launch<kArray>(a, static_cast<cudaStream_t>(stream));
}

// Gathered form: vs (f32) and order (int64), each (n, b) with element
// strides (along samples, along features), one of them 1; the per-sample
// tables wm, rm (f64) and mask (bytes 0/1), n each: the masked weights and
// weight x responses. The tables go to shared memory when they fit beside
// the ring, else they are read from global memory. Returns
// cudaGetLastError() after the launch.
extern "C" int cct_split_scan_gather(const void* vs, long long vs_si, long long vs_sf,
                                     const void* order, long long o_si, long long o_sf,
                                     const void* wm, const void* rm, const void* mask, int n,
                                     int b, int levels, double total_w, double total_r, void* q,
                                     void* thr, void* stream) {
  if (bad_shape(n, b, levels)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaGetLastError());
  Args a = base_args(vs, n, b, levels, total_w, total_r, q, thr);
  a.vs_si = vs_si;
  a.vs_sf = vs_sf;
  a.a1 = order;
  a.a1_si = o_si;
  a.a1_sf = o_sf;
  a.wm = static_cast<const double*>(wm);
  a.rm = static_cast<const double*>(rm);
  a.mask = static_cast<const uint8_t*>(mask);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t shared = table_bytes(n + 1) + Layout<kGatherShared>::kBytes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return shared <= static_cast<size_t>(optin) ? launch<kGatherShared>(a, s)
                                               : launch<kGatherGlobal>(a, s);
}
