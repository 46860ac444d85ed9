// Canvas integrals: inclusive 2-D prefix sums of the pixel canvas and of
// its square, int32 with wrap-around mod 2^32. The canvas is u8 (the fused
// engine's) or int32 (the stage engine's, which the tilted kernel reads too).
//
// Replaces cascadeclassifier_tpu/detect/pallas_integral.py::make_integral_fn.
// The TPU kernel walks 256-row blocks in order and carries the column
// totals in VMEM. Blocks on Hopper run in no order, so the canvas is cut
// into bands of kRows rows and the column carry is made apart, in three
// launches in none of which a block waits on another:
//   1. band_sums   one thread per (band, column): px and px^2 summed down
//                  the band, a warp reading 32 adjacent columns of a row;
//                  bands 0 .. nb-2 only, the last band's sums feed nothing
//   2. band_carry  one block of kStrip columns x kCarryGroups threads per
//                  strip: each thread sums a contiguous group of bands, the
//                  groups' totals are joined through shared memory, and each
//                  thread rewrites its bands in place as the inclusive scan
//                  down the bands: the carry of band k+1
//   3. band_apply  one block per band, the full width in passes of
//                  kThreads x kCols columns. A thread owns kCols adjacent
//                  columns and holds their column sums in registers, from
//                  the carry of the band above. Per row: add the row, the
//                  prefix along the thread's columns, a warp-shuffle scan of
//                  the thread totals, the row staged in shared memory; then
//                  the row's one __syncthreads(), and the threads store the
//                  row in 128-byte-aligned runs of 32 columns a warp, each
//                  column with the offset of the warp that owns it, taken
//                  from the warp totals. A pass after the first starts each
//                  row from the row total of the passes before it.
// Launches 2 and 3 start while the one before drains (programmatic
// dependent launch) and wait for its results in griddepcontrol.wait.
// Every output cell is written once and never read back. All arithmetic is
// uint32 (signed overflow is undefined in C++); addition mod 2^32 is
// associative, so any split gives the int64 cumsum narrowed to int32, bit
// for bit. No per-level top-row reset: every consumer takes 4-corner
// differences.
//
// Bound: device memory. The function reads px once (u8: hw bytes, int32:
// 4hw) and writes both outputs (8hw); at the 1080p plain canvas (11713 x
// 1921) that is 203 MB from a u8 canvas. The kernel adds a second read of
// px (band_apply's) and 4 x 8 B a column per band for the band sums and
// carry. Row starts are w elements apart, not 16-byte aligned at w = 1921,
// so no vector or TMA loads: byte or word loads, coalesced by the warp
// (band_sums) or served by L1 (band_apply's thread-adjacent columns).
// Times on the card and what was tried: PERF.md.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef CCT_INTEGRAL_ROWS
#define CCT_INTEGRAL_ROWS 32  // detect/integral.py: BAND_ROWS
#endif
#ifndef CCT_INTEGRAL_THREADS
#define CCT_INTEGRAL_THREADS 256  // detect/integral.py: APPLY_THREADS
#endif
#ifndef CCT_INTEGRAL_COLS
#define CCT_INTEGRAL_COLS 8  // detect/integral.py: APPLY_COLS
#endif
#ifndef CCT_INTEGRAL_STRIP
#define CCT_INTEGRAL_STRIP 32  // detect/integral.py: CARRY_STRIP
#endif

namespace {

constexpr int kRows = CCT_INTEGRAL_ROWS;
constexpr int kThreads = CCT_INTEGRAL_THREADS;
constexpr int kCols = CCT_INTEGRAL_COLS;
constexpr int kWarps = kThreads / 32;
constexpr int kPass = kThreads * kCols;      // columns a pass of band_apply
constexpr int kPadded = kPass + kPass / 32;  // a staged row, one spare word every 32
constexpr int kSumThreads = 256;
constexpr int kStrip = CCT_INTEGRAL_STRIP;   // columns a block of band_carry
constexpr int kCarryGroups = 1024 / kStrip;  // groups of bands a column, a thread each
constexpr unsigned kFullWarp = 0xffffffffu;
static_assert(kRows >= 1, "a band has rows");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps in one block");
static_assert(kCols >= 1 && kCols <= 32 && (kCols & (kCols - 1)) == 0,
              "columns a thread: a power of two up to 32 (the staging is conflict-free)");

// Where column x of a pass sits in the staged row: thread t writes x = t *
// kCols + j, and the spare word every 32 spreads a warp's writes over the
// 32 banks; a warp's reads of 32 adjacent x stay on 32 banks.
__device__ __forceinline__ int staged(int x) { return x + (x >> 5); }

// A kernel launched with programmatic stream serialization (launch_dep)
// may start while the launch before it drains; it waits here until that
// grid has completed and its writes are visible.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    band_sums(const T* __restrict__ px, uint32_t* __restrict__ tot, int w, int n) {
  const int col = blockIdx.y * kSumThreads + threadIdx.x;
  const int b = blockIdx.x;
  if (col >= w) return;
  const T* p = px + static_cast<size_t>(b) * kRows * w + col;
  uint32_t a = 0u, q = 0u;
#pragma unroll 8
  for (int r = 0; r < kRows; ++r) {
    const uint32_t v = static_cast<uint32_t>(p[static_cast<size_t>(r) * w]);
    a += v;
    q += v * v;
  }
  tot[static_cast<size_t>(b) * w + col] = a;
  tot[(static_cast<size_t>(n) + b) * w + col] = q;
}

// tot: [sum, sq][n bands][w], rewritten in place as the inclusive scan
// down the bands.
__global__ void __launch_bounds__(kStrip * kCarryGroups)
    band_carry(uint32_t* __restrict__ tot, int w, int n) {
  __shared__ uint32_t part[2][kCarryGroups][kStrip];
  grid_dependency_wait();
  const int x = threadIdx.x, y = threadIdx.y;
  const int col = blockIdx.x * kStrip + x;
  const int g = (n + kCarryGroups - 1) / kCarryGroups;
  const int k0 = min(n, y * g), k1 = min(n, k0 + g);
  uint32_t* ta = tot + col;
  uint32_t* tb = tot + static_cast<size_t>(n) * w + col;
  uint32_t a = 0u, b = 0u;
  if (col < w) {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      a += ta[static_cast<size_t>(k) * w];
      b += tb[static_cast<size_t>(k) * w];
    }
  }
  part[0][y][x] = a;
  part[1][y][x] = b;
  __syncthreads();
  a = 0u;
  b = 0u;
  for (int yy = 0; yy < y; ++yy) {
    a += part[0][yy][x];
    b += part[1][yy][x];
  }
  if (col >= w) return;
  for (int k = k0; k < k1; k += 4) {  // four loads in flight before the stores
    uint32_t va[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (k + i < k1) {
        va[i] = ta[static_cast<size_t>(k + i) * w];
        vb[i] = tb[static_cast<size_t>(k + i) * w];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (k + i < k1) {
        a += va[i];
        b += vb[i];
        ta[static_cast<size_t>(k + i) * w] = a;
        tb[static_cast<size_t>(k + i) * w] = b;
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int c0, int w,
                                         uint32_t (&v)[kCols]) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    v[j] = c0 + j < w ? static_cast<uint32_t>(row[c0 + j]) : 0u;
  }
}

// Shared memory (dynamic): the staged row [parity][sum, sq][kPadded], the
// warp totals [parity][sum, sq][kWarps] and the row carry between passes
// [pass parity][sum, sq][kRows]. Parities alternate row by row, so a row's
// stores and the next row's staging need one barrier between them.
constexpr size_t kApplySmem = sizeof(uint32_t) * (4 * kPadded + 4 * kWarps + 4 * kRows);
static_assert(kApplySmem <= 48 * 1024, "past 48 KB a launch needs cudaFuncSetAttribute");

template <typename T>
__global__ void __launch_bounds__(kThreads)
    band_apply(const T* __restrict__ px, const uint32_t* __restrict__ tot,
               uint32_t* __restrict__ sum, uint32_t* __restrict__ sq, int h, int w, int n) {
  extern __shared__ uint32_t smem[];
  grid_dependency_wait();
  uint32_t* const stage = smem;
  uint32_t* const wtot = stage + 4 * kPadded;
  uint32_t* const rcar = wtot + 4 * kWarps;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int b = blockIdx.x;
  const int r0 = b * kRows;
  const int rows = min(kRows, h - r0);
  int it = 0;  // rows done by the block, over every pass: the parity
  for (int p0 = 0, pass = 0; p0 < w; p0 += kPass, ++pass) {
    const int c0 = p0 + t * kCols;  // the thread's first column
    uint32_t acc[kCols], accq[kCols], nxt[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {  // the column sums of every row above the band
      const bool in = b > 0 && c0 + j < w;
      acc[j] = in ? tot[static_cast<size_t>(b - 1) * w + c0 + j] : 0u;
      accq[j] = in ? tot[(static_cast<size_t>(n) + b - 1) * w + c0 + j] : 0u;
    }
    load_row(px + static_cast<size_t>(r0) * w, c0, w, nxt);
    for (int i = 0; i < rows; ++i, ++it) {
      const size_t row = static_cast<size_t>(r0 + i) * w;
      uint32_t cur[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) cur[j] = nxt[j];
      if (i + 1 < rows) load_row(px + row + w, c0, w, nxt);  // one row ahead
      uint32_t ta = 0u, tb = 0u;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        acc[j] += cur[j];
        accq[j] += cur[j] * cur[j];
        ta += acc[j];
        tb += accq[j];
      }
      uint32_t ia = ta, ib = tb;  // inclusive scan of the thread totals over the warp
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t ua = __shfl_up_sync(kFullWarp, ia, o);
        const uint32_t ub = __shfl_up_sync(kFullWarp, ib, o);
        if (lane >= o) {
          ia += ua;
          ib += ub;
        }
      }
      const int par = it & 1;
      uint32_t* const st_a = stage + par * 2 * kPadded;
      uint32_t* const st_b = st_a + kPadded;
      uint32_t* const wt_a = wtot + par * 2 * kWarps;
      uint32_t* const wt_b = wt_a + kWarps;
      uint32_t ea = ia - ta, eb = ib - tb;  // the warp's columns before the thread's
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        ea += acc[j];
        eb += accq[j];
        st_a[staged(t * kCols + j)] = ea;
        st_b[staged(t * kCols + j)] = eb;
      }
      if (lane == 31) {
        wt_a[wid] = ia;
        wt_b[wid] = ib;
      }
      __syncthreads();
      uint32_t oa = 0u, ob = 0u;  // the row before this pass, then the warps before
      if (pass > 0) {
        oa = rcar[(pass & 1) * 2 * kRows + i];
        ob = rcar[((pass & 1) * 2 + 1) * kRows + i];
      }
      int ow = 0;  // warps added to (oa, ob)
      const int al = static_cast<int>((row + p0) & 31);
#pragma unroll
      for (int k = 0; k <= kCols; ++k) {
        const int x = k * kThreads + t - al;
        if (x >= 0 && x < kPass && p0 + x < w) {
          const int owner = x / (32 * kCols);
          for (; ow < owner; ++ow) {
            oa += wt_a[ow];
            ob += wt_b[ow];
          }
          sum[row + p0 + x] = st_a[staged(x)] + oa;
          sq[row + p0 + x] = st_b[staged(x)] + ob;
        }
      }
      if (t == 0 && p0 + kPass < w) {  // the row's total so far, for the next pass
        for (; ow < kWarps; ++ow) {
          oa += wt_a[ow];
          ob += wt_b[ow];
        }
        rcar[((pass + 1) & 1) * 2 * kRows + i] = oa;
        rcar[(((pass + 1) & 1) * 2 + 1) * kRows + i] = ob;
      }
    }
  }
}

// Launches kernel on stream s after the work before it, letting it start
// (programmatic stream serialization) while that work drains: the kernel
// calls grid_dependency_wait() before it reads what the work before wrote.
template <typename... Params, typename... Args>
int launch_dep(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, cudaStream_t s,
               Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

template <typename T>
int launch(const void* px, void* sum, void* sq, void* tot, int h, int w, cudaStream_t s) {
  const int nb = (h + kRows - 1) / kRows;
  const int n = nb - 1;  // bands whose sums feed a carry
  auto* tu = static_cast<uint32_t*>(tot);
  const T* p = static_cast<const T*>(px);
  if (n > 0) {
    band_sums<T><<<dim3(n, (w + kSumThreads - 1) / kSumThreads), kSumThreads, 0, s>>>(p, tu, w,
                                                                                     n);
    const int e = launch_dep(band_carry, dim3((w + kStrip - 1) / kStrip),
                             dim3(kStrip, kCarryGroups), 0, s, tu, w, n);
    if (e != 0) return e;
  }
  const int e = launch_dep(band_apply<T>, dim3(nb), dim3(kThreads), kApplySmem, s, p,
                           static_cast<const uint32_t*>(tu), static_cast<uint32_t*>(sum),
                           static_cast<uint32_t*>(sq), h, w, n);
  if (e != 0) return e;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// px (h, w), elt bytes an element: 1 (uint8) or 4 (int32); sum, sq (h, w)
// int32 outputs; tot: 2 * (ceil(h / rows) - 1) * w uint32 scratch (unused
// when h <= rows). rows must be the compiled band height. Returns
// cudaGetLastError() after the launches.
extern "C" int cct_integral(const void* px, int elt, void* sum, void* sq, void* tot, int h,
                            int w, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 0 || w <= 0 || rows != kRows) return static_cast<int>(cudaErrorInvalidValue);
  if (elt == 1) return launch<uint8_t>(px, sum, sq, tot, h, w, s);
  if (elt == 4) return launch<int32_t>(px, sum, sq, tot, h, w, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
