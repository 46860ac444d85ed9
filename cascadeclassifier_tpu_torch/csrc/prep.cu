// Prep kernel: the fused engine's head in one pass over the canvas: the
// variance gate, stage 0 and OpenCV's serial x-walk at every window, for
// stump-Haar, Haar node-tree and LBP cascades, with the stage sums in f32
// or f64, on the plain stack or the shelf-packed plan.
//
// Replaces the head of cascadeclassifier_tpu/detect/engine.py::FusedEngine
// (its prep: dense_variance_gate, the dense stage-0 pass and
// parity_visited, XLA, not Pallas). Output contract, per window of the
// (out_h, out_w) grid:
//   inv_nf = 1/sqrt(nf2) narrowed to f32 where the gate passes, 1 elsewhere
//            (Haar only: an LBP cascade has no gate and no inv_nf)
//   alive  = gate AND on-grid AND stage 0 passed AND visited by the walk
// bit for bit the plain twin's (detect/prep.py::prep_ref, the torch prep).
//
// Work split. One block owns a band of kTileH window rows and walks the
// band's tiles of 128 columns from left to right. Per tile it copies the
// (kTileH + win_h) x (128 + win_w) patch of the integral canvas into shared
// memory with 4-byte cp.async (cascade_tile.cuh's load_tile; the next
// tile's copy is issued as soon as this one's patch has been read, and
// overlaps the walk), and each thread holds J consecutive rows of one
// column, as the tile kernel's dense pass does:
//   gate   the inner (w-2) x (h-2) rect: four sum corners from the patch and
//          four sq corners from device memory, as uint32 differences read as
//          int32 (the true sums; the canvases wrap mod 2^32). nf2 = area *
//          sum(x^2) - sum(x)^2 in int64, 1/sqrt(nf2) in f64 (IEEE sqrt and
//          division) narrowed to f32; the window passes iff nf2 > 0 and
//          area * inv < 0.1 in f64
//   stage0 the tile kernel's tree and sum policies (StumpHaar,
//          NodeTrees<HaarNode>, NodeTrees<LbpNode>; Acc float or double) at
//          the J windows with the inv just computed, in registers. A warp in
//          which no window is both on the grid and through the gate skips
//          it: there neither alive nor the walk reads stage 0
//   walk   per row, the walk carries one bit, "the next on-column is
//          visited", which starts true at the band's left edge. An on-column
//          whose skip trigger m0 = gate AND NOT passed0 is false sets it; one
//          whose m0 is true flips it; a reset column (between two levels
//          that share a shelf-packed row) sets it; any other column keeps
//          it. Each warp ballots its 32 columns' set and flip bits a row;
//          the bit before a column is the carry passed through the warps to
//          its left and through its own warp's lanes below it (the last set
//          bit, then the parity of the flips after it). parity_visited's
//          closed form gives the same bits. After the tile one thread a row
//          passes the carry through all four warps into shared memory,
//          where the next tile reads it.
//   write  inv_nf (f32) and alive (one byte) of each window, nothing else.
//
// No int64 plane, no passed0 plane and no ordinal plane goes to device
// memory: the int64 products and the f64 root live in registers, stage 0's
// pass and the walk's inputs in registers and two words a warp and row in
// shared memory. The walk's per-window input is one byte of the plan's
// code plane (bit 0 on the visit grid, bit 1 a reset column), built once a
// plan.
//
// Bound: bytes. A 4K frame's shelf-packed canvas (16 020 x 3 841, 61.1 M
// windows) asks for sum and sq read once (246 MB each), the code plane (61
// MB), inv_nf written (245 MB) and alive (61 MB): about 0.86 GB, 0.26 ms
// at 3.35 TB/s. The arithmetic, the gate and stage 0's three stumps of 6k +
// 3 operations at every window, is about 5 G operations. The patches are
// read again across the band's halo (28 rows for 8, from L2). What the
// kernel waits on is latency: the loads behind each tile and three
// barriers a tile. Hence bands of 8 rows (J = 4, twice the blocks of 16),
// and 4 blocks an SM: that register cap (kMinBlocks) keeps a thread at 64
// registers with no spills (70-101 uncapped; 110-140 with 16 rows a band,
// 2 blocks an SM). A second patch buffer, loaded a whole tile ahead,
// gained nothing measurable and is not kept. Times on the card: PERF.md.

#include "cascade_tile.cuh"

namespace {

using cct::kFullWarp;
using cct::kTileW;

// a band's window rows, a block's threads, and the blocks an SM that the
// register cap keeps resident (the note above)
constexpr int kTileH = 8, kThreads = 256, kMinBlocks = 4;

// detect/prep.py: ON_GRID, RESET
constexpr uint8_t kOnGrid = 1, kReset = 2;

struct PrepFrame {
  const int32_t* __restrict__ sum;
  const int32_t* __restrict__ sq;  // not read for LBP
  const uint8_t* __restrict__ code;
  float* __restrict__ inv_out;  // not written for LBP
  uint8_t* __restrict__ alive_out;
  int canvas_w, out_h, out_w, win_h, win_w;
};

// The walk's bit after a run of columns whose set and flip bits are given,
// from the bit before it.
__device__ __forceinline__ bool walk_through(unsigned set, unsigned flip, bool before) {
  if (set != 0u) {
    flip &= ~((2u << (31 - __clz(set))) - 1u);  // the flips after the last set
    before = true;
  }
  return before != static_cast<bool>(__popc(flip) & 1);
}

// The gate at the J windows of one column that ok names (bit j: window
// j): the inner rect's sum corners from the patch (win: the first window's
// cell), its sq corners from the canvas (sq: the first window's cell
// there) → the windows that pass (bits), and inv (1 where the gate fails).
template <int kPitch, int J>
__device__ __forceinline__ unsigned gate(const uint32_t* win, const int32_t* sq, int canvas_w,
                                         int win_w, int win_h, unsigned ok, float (&inv)[J]) {
  const int rw = win_w - 2, rh = win_h - 2;
  const int64_t area = static_cast<int64_t>(rw) * rh;
  const int s0 = kPitch + 1, s1 = s0 + rw, s2 = s0 + rh * kPitch, s3 = s2 + rw;
  const size_t q0 = static_cast<size_t>(canvas_w) + 1, q1 = q0 + rw;
  const size_t q2 = q0 + static_cast<size_t>(rh) * canvas_w, q3 = q2 + rw;
  unsigned pass = 0u;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    inv[j] = 1.0f;
    if (!((ok >> j) & 1u)) continue;
    const uint32_t* w = win + j * kPitch;
    const int32_t* q = sq + static_cast<size_t>(j) * canvas_w;
    const int64_t vs = static_cast<int32_t>(w[s0] - w[s1] - w[s2] + w[s3]);
    const uint32_t p0 = __ldg(q + q0), p1 = __ldg(q + q1), p2 = __ldg(q + q2), p3 = __ldg(q + q3);
    const int64_t vq = static_cast<int32_t>(p0 - p1 - p2 + p3);
    const int64_t nf2 = area * vq - vs * vs;
    if (nf2 <= 0) continue;
    const float r = static_cast<float>(1.0 / sqrt(static_cast<double>(nf2)));
    if (static_cast<double>(area) * static_cast<double>(r) < 0.1) {
      pass |= 1u << j;
      inv[j] = r;
    }
  }
  return pass;
}

template <int kPitch, bool kGate, class Trees, class Acc>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    prep_kernel(PrepFrame f, cct::Cascade cas) {
  constexpr int kWarpsX = kTileW / 32;
  constexpr int kWarpsY = kThreads / 32 / kWarpsX;
  constexpr int J = kTileH / kWarpsY;  // rows of one column a thread holds
  static_assert(kWarpsX * kWarpsY * 32 == kThreads && J * kWarpsY == kTileH && J >= 1,
                "threads must tile the windows");

  extern __shared__ __align__(16) unsigned char shared[];
  __shared__ uint2 words[kTileH][kWarpsX];  // a warp's (set, flip) ballots a row
  __shared__ bool carry[kTileH];            // the walk's bit at the tile's left edge
  uint32_t* tile = reinterpret_cast<uint32_t*>(shared);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wx = warp % kWarpsX;
  const int col = wx * 32 + lane;
  const int row0 = (warp / kWarpsX) * J;
  const int r0 = blockIdx.x * kTileH;
  const int rows = kTileH + f.win_h, cols = kTileW + f.win_w;
  const int canvas_h = f.out_h + f.win_h;
  const unsigned below = (1u << lane) - 1u;
  const int t_begin = cas.stage_start[0], t_end = cas.stage_start[1];
  const Acc stage_thr = static_cast<Acc>(cas.stage_thr[0]);

  if (threadIdx.x < kTileH) carry[threadIdx.x] = true;
  cct::load_tile<kPitch, kThreads>(tile, f.sum, canvas_h, f.canvas_w, r0, 0, rows, cols);
  for (int c0 = 0; c0 < f.out_w; c0 += kTileW) {
    cct::cp_async_wait_all();
    __syncthreads();  // the patch is in; the carry of the tile before is written

    // a thread's J windows as bit masks: bit j is window row0 + j
    const int c = c0 + col;
    const size_t g0 = static_cast<size_t>(r0 + row0) * f.out_w + c;  // window (row0, col)
    unsigned ok = 0u, on = 0u, rst = 0u;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (c < f.out_w && r0 + row0 + j < f.out_h) {
        const unsigned code = f.code[g0 + static_cast<size_t>(j) * f.out_w];
        ok |= 1u << j;
        on |= ((code & kOnGrid) != 0u ? 1u : 0u) << j;
        rst |= ((code & kReset) != 0u ? 1u : 0u) << j;
      }
    }
    const uint32_t* win = tile + row0 * kPitch + col;
    float inv[J];
    unsigned pass = ok;  // through the gate (every window for LBP)
    if constexpr (kGate) {
      pass = gate<kPitch, J>(win, f.sq + static_cast<size_t>(r0 + row0) * f.canvas_w + c,
                             f.canvas_w, f.win_w, f.win_h, ok, inv);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if ((ok >> j) & 1u) f.inv_out[g0 + static_cast<size_t>(j) * f.out_w] = inv[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) inv[j] = 1.0f;
    }

    unsigned passed = 0u;  // stage 0
    if (__any_sync(kFullWarp, (on & pass) != 0u)) {
      Acc ssum[J];
#pragma unroll
      for (int j = 0; j < J; ++j) ssum[j] = static_cast<Acc>(0);
      for (int t = t_begin; t < t_end; ++t) {
        float leaf[J];
        Trees::template leaves<kPitch, J>(cas, t, win, inv, leaf);
#pragma unroll
        for (int j = 0; j < J; ++j) ssum[j] = ssum[j] + static_cast<Acc>(leaf[j]);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) passed |= (ssum[j] >= stage_thr ? 1u : 0u) << j;
    }

    const unsigned m0 = pass & ~passed;  // the walk's skip trigger
    const unsigned set = rst | (on & ~m0), flip = on & m0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const unsigned s = __ballot_sync(kFullWarp, (set >> j) & 1u);
      const unsigned fl = __ballot_sync(kFullWarp, (flip >> j) & 1u);
      if (lane == 0) words[row0 + j][wx] = make_uint2(s, fl);
    }
    const unsigned live = pass & on & passed;  // alive where the walk visits
    __syncthreads();  // the patch is read; every warp's ballots are in

    if (c0 + kTileW < f.out_w) {  // the next patch, while the walk finishes this tile
      cct::load_tile<kPitch, kThreads>(tile, f.sum, canvas_h, f.canvas_w, r0, c0 + kTileW, rows,
                                       cols);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (!((ok >> j) & 1u)) continue;
      bool bit = carry[row0 + j];
      for (int w = 0; w < wx; ++w) {
        const uint2 word = words[row0 + j][w];
        bit = walk_through(word.x, word.y, bit);
      }
      const uint2 own = words[row0 + j][wx];
      const bool visited = walk_through(own.x & below, own.y & below, bit);
      f.alive_out[g0 + static_cast<size_t>(j) * f.out_w] = ((live >> j) & 1u) && visited;
    }
    __syncthreads();  // every thread has read the carry
    if (threadIdx.x < kTileH) {
      bool bit = carry[threadIdx.x];
#pragma unroll
      for (int w = 0; w < kWarpsX; ++w) {
        bit = walk_through(words[threadIdx.x][w].x, words[threadIdx.x][w].y, bit);
      }
      carry[threadIdx.x] = bit;
    }
  }
}

template <int kPitch, bool kGate, class Trees, class Acc>
int prep_launch(const PrepFrame& f, const cct::Cascade& cas, cudaStream_t stream) {
  const auto kernel = prep_kernel<kPitch, kGate, Trees, Acc>;
  const size_t bytes = static_cast<size_t>(kTileH + f.win_h) * kPitch * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned bands = static_cast<unsigned>((f.out_h + kTileH - 1) / kTileH);
  kernel<<<bands, kThreads, bytes, stream>>>(f, cas);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGate, class Trees, class Acc>
int prep_dispatch(int pitch, const PrepFrame& f, const cct::Cascade& cas, cudaStream_t stream) {
  switch (pitch) {
    case 152:
      return prep_launch<152, kGate, Trees, Acc>(f, cas, stream);
    case 200:
      return prep_launch<200, kGate, Trees, Acc>(f, cas, stream);
    case 264:
      return prep_launch<264, kGate, Trees, Acc>(f, cas, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kGate, class Trees>
int prep_dispatch_exact(int exact, int pitch, const PrepFrame& f, const cct::Cascade& cas,
                   cudaStream_t stream) {
  return exact ? prep_dispatch<kGate, Trees, double>(pitch, f, cas, stream)
               : prep_dispatch<kGate, Trees, float>(pitch, f, cas, stream);
}

}  // namespace

// sum, sq: (out_h + win_h, canvas_w) int32 canvases (sq null for LBP);
// code (out_h, out_w) u8 (bit 0 on the visit grid, bit 1 a reset column);
// inv_out (out_h, out_w) f32 (null for LBP), alive_out (out_h, out_w) u8;
// kind (cct::Kind) and exact (f64 stage sums) pick the policies; records
// resolved against pitch, tree_root and leaves for node trees (null for
// stumps). Returns the first CUDA error of the launch.
extern "C" int cct_prep(const void* sum, const void* sq, int canvas_w, const void* code,
                        void* inv_out, void* alive_out, int out_h, int out_w, int win_h,
                        int win_w, int kind, int exact, const void* records, int pitch,
                        const void* tree_root, const void* leaves, const void* stage_start,
                        const void* stage_thr, void* stream) {
  if (out_h <= 0 || out_w <= 0 || win_w < 3 || win_h < 3 || kTileW + win_w > pitch ||
      canvas_w != out_w + win_w || (kind != cct::kLbp && (sq == nullptr || inv_out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PrepFrame f{static_cast<const int32_t*>(sum), static_cast<const int32_t*>(sq),
                    static_cast<const uint8_t*>(code), static_cast<float*>(inv_out),
                    static_cast<uint8_t*>(alive_out), canvas_w, out_h, out_w, win_h, win_w};
  const cct::Cascade cas{static_cast<const uint4*>(records),
                         static_cast<const int32_t*>(stage_start),
                         static_cast<const float*>(stage_thr),
                         static_cast<const int32_t*>(tree_root),
                         static_cast<const float*>(leaves)};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case cct::kStump:
      return prep_dispatch_exact<true, cct::StumpHaar>(exact, pitch, f, cas, st);
    case cct::kNode:
      return prep_dispatch_exact<true, cct::NodeTrees<cct::HaarNode>>(exact, pitch, f, cas, st);
    case cct::kLbp:
      return prep_dispatch_exact<false, cct::NodeTrees<cct::LbpNode>>(exact, pitch, f, cas, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
