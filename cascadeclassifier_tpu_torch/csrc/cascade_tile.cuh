// The tiled cascade kernel behind front.cu and stage.cu: stump-Haar stages
// [s0, s1) at the windows of one canvas tile per thread block.
//
// One block owns kTileH x kTileW windows and does, in order:
//   skip     read the tile's alive_in bytes; when no window is alive (and
//            stage 0 is not due at every window) write zeros and leave,
//            with the canvas untouched
//   tile     copy the (kTileH + win_h) x (kTileW + win_w) patch of the
//            integral canvas, and of the tilted canvas behind it when the
//            cascade has tilted trees, into shared memory with 4-byte
//            cp.async (the canvas pitch, 4 * canvas_w bytes, is not a
//            multiple of 16, so wider copies and TMA are out); cells past
//            the canvas are zero and only masked windows read them
//   dense    stage kernel with s0 == 0 only: stage 0 at every window of the
//            tile. Lanes hold consecutive columns (conflict-free shared
//            reads) and each thread holds J consecutive rows of its
//            column, so a tree's record is decoded once for J windows,
//            the J rows of a corner are one address plus constants, and J
//            independent gather chains are in flight
//   compact  the alive windows go into a shared-memory list (warp ballot,
//            prefix count, one shared atomic a warp); then per stage the
//            lanes take the list's entries, so every lane holds a live
//            window, and the survivors go into the other list (two
//            lists, swapped) until the list is empty or s1 is reached.
//            A list shorter than the block spreads each window's trees
//            over 2 to 32 lanes (list_stage), which shortens the chain of
//            dependent trees: these passes are bound by latency
//   write    the survivors are scattered into a shared byte mask and the
//            whole tile is stored with coalesced byte stores
//
// The shared atomics make a list's order differ from run to run. No result
// depends on it: every window's f32 stage sum is formed in tree order
// whichever lanes hold it, and the output is a mask indexed by window.
//
// A tree is one 48-byte record (detect/records.py), read as three 16-byte
// words through the read-only path (with one address for the whole warp
// where a lane holds a window):
//   q0 = corners of rect 0 and rect 1 (4 x 16 bits each)
//   q1 = corners of rect 2, weight 0, weight 1
//   q2 = weight 2, thr, left, right
// Corners are cell offsets from the window's own cell in the shared image
// (tilted trees' corners point into the tilted patch), in the order
// c0 - c1 - c2 + c3, so upright and tilted trees run the same code.
// Weighted rects come first; a slot of weight 0 ends them.
// The pitch of the shared image is a template constant, so one binary
// serves every cascade whose window fits a compiled pitch: 152, 200 or 264
// cells, each 8 or 24 mod 32, so that in the list passes the windows of
// neighbouring rows fall into different shared-memory banks.
//
// Arithmetic, per window and tree, bit for bit dense_stage_haar(exact=
// False)'s: corner sums in uint32 read as int32 (a tilted "sum" across a
// block top is negative), raw = f32(rect0)*w0 (+ f32(rect1)*w1 (+ ...)),
// val = raw * inv_nf, ssum = ssum + (val < thr ? left : right) once per
// tree in tree order from 0.0f, pass iff ssum >= stage_thr. Built with
// --fmad=false, so no multiply-add is contracted.
//
// Every thread reaches every barrier: the tile skip leaves with the whole
// block, partial tiles at the right and bottom edges are masked, and the
// stage loop breaks on a count that all threads read after a barrier.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cct {

constexpr int kTileW = 128;
constexpr unsigned kFullWarp = 0xffffffffu;

struct Cascade {
  const uint4* __restrict__ records;  // three words a tree
  const int32_t* __restrict__ stage_start;
  const float* __restrict__ stage_thr;
};

struct Frame {
  const int32_t* __restrict__ sum;
  const int32_t* __restrict__ tilt;  // read only when has_tilt
  const float* __restrict__ inv;
  const uint8_t* __restrict__ alive_in;
  uint8_t* __restrict__ alive_out;
  uint8_t* __restrict__ passed0;  // stage kernel only
  int canvas_w, out_h, out_w, win_h, win_w, has_tilt;
};

__device__ __forceinline__ void cp_async4(uint32_t* dst, const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows x cols cells of the canvas from (r0, c0) into tile, asynchronously;
// a warp takes a row at a time.
template <int kPitch, int kThreads>
__device__ __forceinline__ void load_tile(uint32_t* tile, const int32_t* __restrict__ canvas,
                                          int canvas_h, int canvas_w, int r0, int c0, int rows,
                                          int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int y = warp; y < rows; y += kThreads / 32) {
    const bool row_ok = r0 + y < canvas_h;
    const int32_t* src = canvas + static_cast<size_t>(r0 + y) * canvas_w + c0;
    uint32_t* dst = tile + y * kPitch;
    for (int x = lane; x < cols; x += 32) {
      if (row_ok && c0 + x < canvas_w) {
        cp_async4(dst + x, src + x);
      } else {
        dst[x] = 0u;
      }
    }
  }
}

// One rect of one tree at J windows in consecutive rows of one column.
template <int kPitch, int J, bool kFirst>
__device__ __forceinline__ void rect_terms(const uint32_t* win, uint32_t c01, uint32_t c23,
                                           float wt, float (&raw)[J]) {
  const uint32_t* p0 = win + (c01 & 0xffffu);
  const uint32_t* p1 = win + (c01 >> 16);
  const uint32_t* p2 = win + (c23 & 0xffffu);
  const uint32_t* p3 = win + (c23 >> 16);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const uint32_t u = p0[j * kPitch] - p1[j * kPitch] - p2[j * kPitch] + p3[j * kPitch];
    const float term = static_cast<float>(static_cast<int32_t>(u)) * wt;
    raw[j] = kFirst ? term : raw[j] + term;
  }
}

struct Tree {
  uint4 q0, q1, q2;
};

__device__ __forceinline__ Tree load_tree(const Cascade& cas, int t) {
  const uint4* rec = cas.records + 3 * t;
  return Tree{__ldg(rec), __ldg(rec + 1), __ldg(rec + 2)};
}

// One tree at J windows: each window's leaf.
template <int kPitch, int J>
__device__ __forceinline__ void tree_leaves(const Tree& tree, const uint32_t* win,
                                            const float (&inv)[J], float (&leaf)[J]) {
  const uint4 q0 = tree.q0, q1 = tree.q1, q2 = tree.q2;
  const float w0 = __uint_as_float(q1.z), w1 = __uint_as_float(q1.w);
  const float w2 = __uint_as_float(q2.x), thr = __uint_as_float(q2.y);
  const float left = __uint_as_float(q2.z), right = __uint_as_float(q2.w);
  float raw[J];
  rect_terms<kPitch, J, true>(win, q0.x, q0.y, w0, raw);
  if (w1 != 0.0f) {
    rect_terms<kPitch, J, false>(win, q0.z, q0.w, w1, raw);
    if (w2 != 0.0f) rect_terms<kPitch, J, false>(win, q1.x, q1.y, w2, raw);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float val = raw[j] * inv[j];
    leaf[j] = val < thr ? left : right;
  }
}

// Appends w to the list for every lane that keeps; whole warps call it.
__device__ __forceinline__ void push(bool keep, int w, uint16_t* list, int* count) {
  const unsigned votes = __ballot_sync(kFullWarp, keep);
  if (votes == 0u) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(votes));
  base = __shfl_sync(kFullWarp, base, 0);
  if (keep) list[base + __popc(votes & ((1u << lane) - 1u))] = static_cast<uint16_t>(w);
}

// The trees [t0, t1) of one stage at the n windows of the list, G lanes
// a window; the windows that pass go into next. The G lanes of a window
// take G consecutive trees at a time, and every lane then adds those
// leaves in tree order (shuffles), so the sum is the one a single lane
// would form one tree after the other, while a short list still keeps the
// block's lanes busy and the chain of dependent trees is G times shorter:
// these passes are bound by latency. A lane past the stage's last tree
// evaluates that tree again and its leaf is not added.
template <int kPitch, int kThreads, int G>
__device__ __forceinline__ void list_stage(const Frame& f, const Cascade& cas,
                                           const uint32_t* tile, const uint16_t* list, int n,
                                           uint16_t* next, int* next_count, int s, int r0,
                                           int c0) {
  const int t0 = cas.stage_start[s], t1 = cas.stage_start[s + 1];
  const float stage_thr = cas.stage_thr[s];
  const int sub = threadIdx.x & (G - 1);
  for (int first = 0; first < n; first += kThreads / G) {
    const int slot = first + threadIdx.x / G;
    const bool valid = slot < n;
    const int w = valid ? list[slot] : 0;  // window 0 of a tile always exists
    const int wr = w / kTileW, wc = w % kTileW;
    const float inv[1] = {f.inv[static_cast<size_t>(r0 + wr) * f.out_w + c0 + wc]};
    const uint32_t* win = tile + wr * kPitch + wc;
    float ssum = 0.0f;
    for (int tb = t0; tb < t1; tb += G) {
      float leaf[1];
      tree_leaves<kPitch, 1>(load_tree(cas, min(tb + sub, t1 - 1)), win, inv, leaf);
#pragma unroll
      for (int l = 0; l < G; ++l) {
        const float v = G == 1 ? leaf[0] : __shfl_sync(kFullWarp, leaf[0], l, G);
        if (tb + l < t1) ssum = ssum + v;
      }
    }
    push(valid && sub == 0 && ssum >= stage_thr, w, next, next_count);
  }
}

template <int kTileH>
constexpr size_t shared_bytes(int pitch, int win_h, int tiles) {
  // the patches, two window lists (16 bits an entry), the byte mask
  return static_cast<size_t>(tiles) * (kTileH + win_h) * pitch * 4 +
         static_cast<size_t>(kTileH) * kTileW * (2 + 2 + 1);
}

template <int kPitch, int kTileH, int kThreads, bool kStage>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(Frame f, Cascade cas, int s0, int s1) {
  constexpr int kWindows = kTileH * kTileW;
  constexpr int kWarpsX = kTileW / 32;
  constexpr int kWarpsY = kThreads / 32 / kWarpsX;
  constexpr int J = kTileH / kWarpsY;  // rows of one column a thread holds
  static_assert(kWarpsX * kWarpsY * 32 == kThreads && J * kWarpsY == kTileH && J >= 1,
                "threads must tile the windows");
  static_assert(kWindows <= 65536 && kWindows % 4 == 0, "a window index is 16 bits");

  extern __shared__ __align__(16) unsigned char shared[];
  __shared__ int count[3];
  const int rows = kTileH + f.win_h, cols = kTileW + f.win_w;
  const int tiles = (kStage && f.has_tilt) ? 2 : 1;
  uint32_t* tile = reinterpret_cast<uint32_t*>(shared);
  uint16_t* list = reinterpret_cast<uint16_t*>(tile + tiles * rows * kPitch);
  uint16_t* next = list + kWindows;
  uint8_t* mask = reinterpret_cast<uint8_t*>(next + kWindows);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = (warp % kWarpsX) * 32 + lane;
  const int row0 = (warp / kWarpsX) * J;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  const size_t g0 = static_cast<size_t>(r0 + row0) * f.out_w + c0 + col;  // window (row0, col)
  const bool dense0 = kStage && s0 == 0 && s1 > 0;

  bool ok[J], alive[J];
  bool any = false;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    ok[j] = c0 + col < f.out_w && r0 + row0 + j < f.out_h;
    alive[j] = ok[j] && f.alive_in[g0 + static_cast<size_t>(j) * f.out_w] != 0;
    any = any || alive[j];
  }
  if (!dense0 && !__syncthreads_or(any)) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (!ok[j]) continue;
      f.alive_out[g0 + static_cast<size_t>(j) * f.out_w] = 0;
      if (kStage) f.passed0[g0 + static_cast<size_t>(j) * f.out_w] = 0;
    }
    return;
  }

  load_tile<kPitch, kThreads>(tile, f.sum, f.out_h + f.win_h, f.canvas_w, r0, c0, rows, cols);
  if (tiles == 2) {
    load_tile<kPitch, kThreads>(tile + rows * kPitch, f.tilt, f.out_h + f.win_h, f.canvas_w,
                                r0, c0, rows, cols);
  }
  if (threadIdx.x < 3) count[threadIdx.x] = 0;
  for (int i = threadIdx.x; i < kWindows / 4; i += kThreads) {
    reinterpret_cast<uint32_t*>(mask)[i] = 0u;
  }
  float inv[J];
  if (dense0) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      inv[j] = ok[j] ? f.inv[g0 + static_cast<size_t>(j) * f.out_w] : 1.0f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  int s = s0;
  if (kStage) {
    if (dense0) {
      float ssum[J];
#pragma unroll
      for (int j = 0; j < J; ++j) ssum[j] = 0.0f;
      const uint32_t* win = tile + row0 * kPitch + col;
      const int t1 = cas.stage_start[1];
      for (int t = cas.stage_start[0]; t < t1; ++t) {
        float leaf[J];
        tree_leaves<kPitch, J>(load_tree(cas, t), win, inv, leaf);
#pragma unroll
        for (int j = 0; j < J; ++j) ssum[j] = ssum[j] + leaf[j];
      }
      const float stage_thr = cas.stage_thr[0];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const bool passed = ssum[j] >= stage_thr;
        if (ok[j]) f.passed0[g0 + static_cast<size_t>(j) * f.out_w] = passed;
        alive[j] = alive[j] && passed;
      }
      s = 1;
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (ok[j]) f.passed0[g0 + static_cast<size_t>(j) * f.out_w] = 0;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < J; ++j) push(alive[j], (row0 + j) * kTileW + col, list, &count[0]);

  // stage k reads count[k % 3], fills count[(k + 1) % 3] and clears
  // count[(k + 2) % 3], which every thread read before this stage's barrier
  int k = 0;
  for (; s < s1; ++s, ++k) {
    __syncthreads();
    const int n = count[k % 3];
    if (n == 0) break;
    if (threadIdx.x == 0) count[(k + 2) % 3] = 0;
    // the most lanes a window (a power of two) that one round still holds
    int lanes = 1;
    while (lanes < 32 && 2 * lanes * n <= kThreads) lanes *= 2;
    int* filled = &count[(k + 1) % 3];
    switch (lanes) {
      case 1:
        list_stage<kPitch, kThreads, 1>(f, cas, tile, list, n, next, filled, s, r0, c0);
        break;
      case 2:
        list_stage<kPitch, kThreads, 2>(f, cas, tile, list, n, next, filled, s, r0, c0);
        break;
      case 4:
        list_stage<kPitch, kThreads, 4>(f, cas, tile, list, n, next, filled, s, r0, c0);
        break;
      case 8:
        list_stage<kPitch, kThreads, 8>(f, cas, tile, list, n, next, filled, s, r0, c0);
        break;
      case 16:
        list_stage<kPitch, kThreads, 16>(f, cas, tile, list, n, next, filled, s, r0, c0);
        break;
      default:
        list_stage<kPitch, kThreads, 32>(f, cas, tile, list, n, next, filled, s, r0, c0);
    }
    uint16_t* done = list;
    list = next;
    next = done;
  }

  __syncthreads();
  const int n = count[k % 3];
  for (int i = threadIdx.x; i < n; i += kThreads) mask[list[i]] = 1;
  __syncthreads();
  for (int i = threadIdx.x; i < kWindows; i += kThreads) {
    const int wr = i / kTileW, wc = i % kTileW;
    if (r0 + wr < f.out_h && c0 + wc < f.out_w) {
      f.alive_out[static_cast<size_t>(r0 + wr) * f.out_w + c0 + wc] = mask[i];
    }
  }
}

// Launches the kernel for one pitch; returns the first CUDA error.
template <int kPitch, int kTileH, int kThreads, bool kStage>
int launch(const Frame& f, const Cascade& cas, int s0, int s1, cudaStream_t stream) {
  const auto kernel = tile_kernel<kPitch, kTileH, kThreads, kStage>;
  const size_t bytes = shared_bytes<kTileH>(kPitch, f.win_h, (kStage && f.has_tilt) ? 2 : 1);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((f.out_w + kTileW - 1) / kTileW, (f.out_h + kTileH - 1) / kTileH);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, kThreads, bytes, stream>>>(f, cas, s0, s1);
  return static_cast<int>(cudaGetLastError());
}

// pitch is the one the records were resolved against (records.py's
// tile_pitch); a pitch that was not compiled is refused.
template <int kTileH, int kThreads, bool kStage>
int dispatch(int pitch, const Frame& f, const Cascade& cas, int s0, int s1,
             cudaStream_t stream) {
  if (f.out_h <= 0 || f.out_w <= 0 || s0 < 0 || s1 < s0 || kTileW + f.win_w > pitch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (pitch) {
    case 152:
      return launch<152, kTileH, kThreads, kStage>(f, cas, s0, s1, stream);
    case 200:
      return launch<200, kTileH, kThreads, kStage>(f, cas, s0, s1, stream);
    case 264:
      return launch<264, kTileH, kThreads, kStage>(f, cas, s0, s1, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace cct
