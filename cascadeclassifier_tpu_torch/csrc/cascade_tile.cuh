// The tiled cascade kernel behind front.cu, stage.cu, packed_front.cu,
// tile_node.cu and tile_lbp.cu: stages [s0, s1) of a cascade at the windows
// of one canvas tile per thread block.
//
// One block owns kTileH x kTileW windows and does, in order:
//   origin   where its tile lies: the Origin functor maps the block index to
//            the tile's first window. GridOrigin tiles the whole window grid
//            (front, stage); an origin that reads a tile list
//            (packed_front.cu) may also send the whole block home before
//            any barrier, with no memory touched
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
// depends on it: every window's stage sum is formed in tree order whichever
// lanes hold it, and the output is a mask indexed by window.
//
// Two template parameters make the cascade's kind (detect/records.py):
//   Trees  how one tree gives a window its leaf (f32):
//          StumpHaar             one 48-byte record a tree (below)
//          NodeTrees<HaarNode>   a Haar node tree: one 48-byte record a node
//          NodeTrees<LbpNode>    an LBP stump or node tree: 80 bytes a node
//   Acc    the stage sum's type: float (the JAX package's exact=False) or
//          double (exact=True, OpenCV's runtime): every leaf is widened to
//          Acc before its add, the sum starts at 0 and takes one add a tree
//          in tree order, and passes iff sum >= (Acc)stage_thr
//
// A stump-Haar tree is one record, read as three 16-byte words through the
// read-only path (with one address for the whole warp where a lane holds a
// window):
//   q0 = corners of rect 0 and rect 1 (4 x 16 bits each)
//   q1 = corners of rect 2, weight 0, weight 1
//   q2 = weight 2, thr, left leaf, right leaf
// Corners are cell offsets from the window's own cell in the shared image
// (tilted trees' corners point into the tilted patch), in the order
// c0 - c1 - c2 + c3, so upright and tilted trees run the same code.
// Weighted rects come first; a slot of weight 0 ends them. A Haar node
// has the same words with the leaves replaced by child codes (int32); an
// LBP node is
//   q0, q1 = the 16 corners of its 4 x 4 grid, row by row (16 bits each)
//   q2, q3 = the 8 subset words
//   q4 = left child code, right child code, 0, 0
// A child code c >= 0 is the record index of an internal node, c < 0 the
// leaf ~c of the leaf table; tree t's root is node tree_root[t].
// The pitch of the shared image is a template constant, so one binary
// serves every cascade whose window fits a compiled pitch: 152, 200 or 264
// cells, each 8 or 24 mod 32, so that in the list passes the windows of
// neighbouring rows fall into different shared-memory banks.
//
// Arithmetic, per window and tree, bit for bit the twins' (detect/dense.py):
// corner sums in uint32 read as int32 (a tilted "sum" across a block top is
// negative). Haar: raw = f32(rect0)*w0 (+ f32(rect1)*w1 (+ ...)), val =
// raw * inv_nf, left iff val < thr. LBP: the 9 cell sums of the grid, the
// code's bit (128 top left, then clockwise) set iff the cell's int32 sum
// >= the centre's, left iff bit (code & 31) of subset word code >> 5 is
// set; LBP reads no inv_nf. Built with --fmad=false, so no multiply-add is
// contracted.
//
// Every thread reaches every barrier: the origin and the tile skip leave
// with the whole block, partial tiles at the right and bottom edges are
// masked, and the stage loop breaks on a count that all threads read after
// a barrier. A node walk diverges by window; every shuffle after it names
// the full warp.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// tile geometries (detect/records.py: TILE_H must equal both tile heights)
#ifndef CCT_FRONT_TILE_H
#define CCT_FRONT_TILE_H 16
#endif
#ifndef CCT_FRONT_THREADS
#define CCT_FRONT_THREADS 256
#endif
#ifndef CCT_STAGE_TILE_H
#define CCT_STAGE_TILE_H 16
#endif
#ifndef CCT_STAGE_THREADS
#define CCT_STAGE_THREADS 256
#endif

namespace cct {

constexpr int kTileW = 128;
constexpr unsigned kFullWarp = 0xffffffffu;

// the cascade kinds of the entry points (detect/records.py: KINDS)
enum Kind { kStump = 0, kNode = 1, kLbp = 2 };

struct Cascade {
  const uint4* __restrict__ records;  // a tree's or a node's words
  const int32_t* __restrict__ stage_start;
  const float* __restrict__ stage_thr;
  const int32_t* __restrict__ tree_root;  // node trees only
  const float* __restrict__ leaves;       // node trees only
};

struct Frame {
  const int32_t* __restrict__ sum;
  const int32_t* __restrict__ tilt;  // read only when has_tilt
  const float* __restrict__ inv;     // not read for LBP
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

// A Haar record's normalized value at J windows: raw * inv.
template <int kPitch, int J>
__device__ __forceinline__ void haar_values(const Tree& tree, const uint32_t* win,
                                            const float (&inv)[J], float (&val)[J]) {
  const uint4 q0 = tree.q0, q1 = tree.q1, q2 = tree.q2;
  const float w0 = __uint_as_float(q1.z), w1 = __uint_as_float(q1.w);
  const float w2 = __uint_as_float(q2.x);
  float raw[J];
  rect_terms<kPitch, J, true>(win, q0.x, q0.y, w0, raw);
  if (w1 != 0.0f) {
    rect_terms<kPitch, J, false>(win, q0.z, q0.w, w1, raw);
    if (w2 != 0.0f) rect_terms<kPitch, J, false>(win, q1.x, q1.y, w2, raw);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) val[j] = raw[j] * inv[j];
}

// Tree policy: one stump-Haar record a tree, its leaves in the record.
struct StumpHaar {
  static constexpr bool kReadsInv = true;

  template <int kPitch, int J>
  static __device__ __forceinline__ void leaves(const Cascade& cas, int t, const uint32_t* win,
                                                const float (&inv)[J], float (&leaf)[J]) {
    const Tree tree = load_tree(cas, t);
    const float thr = __uint_as_float(tree.q2.y);
    const float left = __uint_as_float(tree.q2.z), right = __uint_as_float(tree.q2.w);
    float val[J];
    haar_values<kPitch, J>(tree, win, inv, val);
#pragma unroll
    for (int j = 0; j < J; ++j) leaf[j] = val[j] < thr ? left : right;
  }
};

// Node of a Haar tree: the child code at J windows.
struct HaarNode {
  static constexpr bool kReadsInv = true;

  template <int kPitch, int J>
  static __device__ __forceinline__ void split(const Cascade& cas, int node, const uint32_t* win,
                                               const float (&inv)[J], int (&code)[J]) {
    const Tree nd = load_tree(cas, node);
    const float thr = __uint_as_float(nd.q2.y);
    const int left = static_cast<int>(nd.q2.z), right = static_cast<int>(nd.q2.w);
    float val[J];
    haar_values<kPitch, J>(nd, win, inv, val);
#pragma unroll
    for (int j = 0; j < J; ++j) code[j] = val[j] < thr ? left : right;
  }
};

// Node of an LBP tree: the child code at J windows. 16 corner reads give
// the 9 cell sums (uint32 differences read as int32), the code, and the
// subset bit from the record's word code >> 5.
struct LbpNode {
  static constexpr bool kReadsInv = false;

  template <int kPitch, int J>
  static __device__ __forceinline__ void split(const Cascade& cas, int node, const uint32_t* win,
                                               const float (&)[J], int (&code)[J]) {
    const uint4* rec = cas.records + 5 * node;
    const uint4 q0 = __ldg(rec), q1 = __ldg(rec + 1), q4 = __ldg(rec + 4);
    const uint32_t words[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    const int32_t* subset = reinterpret_cast<const int32_t*>(rec + 2);
    const int left = static_cast<int>(q4.x), right = static_cast<int>(q4.y);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const uint32_t* w = win + j * kPitch;
      uint32_t p[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) p[k] = w[(words[k >> 1] >> (16 * (k & 1))) & 0xffffu];
      int32_t cs[9];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int k = 4 * r + c;
          cs[3 * r + c] = static_cast<int32_t>(p[k] - p[k + 1] - p[k + 4] + p[k + 5]);
        }
      }
      const int32_t centre = cs[4];
      const int lbp = (cs[0] >= centre ? 128 : 0) | (cs[1] >= centre ? 64 : 0) |
                      (cs[2] >= centre ? 32 : 0) | (cs[5] >= centre ? 16 : 0) |
                      (cs[8] >= centre ? 8 : 0) | (cs[7] >= centre ? 4 : 0) |
                      (cs[6] >= centre ? 2 : 0) | (cs[3] >= centre ? 1 : 0);
      const int32_t word = __ldg(subset + (lbp >> 5));
      code[j] = ((word >> (lbp & 31)) & 1) ? left : right;
    }
  }
};

// Tree policy: node trees of Node. Every window of the J takes the root
// together; each then walks its own path to a leaf.
template <class Node>
struct NodeTrees {
  static constexpr bool kReadsInv = Node::kReadsInv;

  template <int kPitch, int J>
  static __device__ __forceinline__ void leaves(const Cascade& cas, int t, const uint32_t* win,
                                                const float (&inv)[J], float (&leaf)[J]) {
    int code[J];
    Node::template split<kPitch, J>(cas, __ldg(cas.tree_root + t), win, inv, code);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      int c = code[j];
      while (c >= 0) {
        const float inv1[1] = {inv[j]};
        int next[1];
        Node::template split<kPitch, 1>(cas, c, win + j * kPitch, inv1, next);
        c = next[0];
      }
      leaf[j] = __ldg(cas.leaves + ~c);
    }
  }
};

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
template <int kPitch, int kThreads, int G, class Trees, class Acc>
__device__ __forceinline__ void list_stage(const Frame& f, const Cascade& cas,
                                           const uint32_t* tile, const uint16_t* list, int n,
                                           uint16_t* next, int* next_count, int s, int r0,
                                           int c0) {
  const int t0 = cas.stage_start[s], t1 = cas.stage_start[s + 1];
  const Acc stage_thr = static_cast<Acc>(cas.stage_thr[s]);
  const int sub = threadIdx.x & (G - 1);
  for (int first = 0; first < n; first += kThreads / G) {
    const int slot = first + threadIdx.x / G;
    const bool valid = slot < n;
    const int w = valid ? list[slot] : 0;  // window 0 of a tile always exists
    const int wr = w / kTileW, wc = w % kTileW;
    const float inv[1] = {Trees::kReadsInv ? f.inv[static_cast<size_t>(r0 + wr) * f.out_w + c0 + wc]
                                           : 1.0f};
    const uint32_t* win = tile + wr * kPitch + wc;
    Acc ssum = static_cast<Acc>(0);
    for (int tb = t0; tb < t1; tb += G) {
      float leaf[1];
      Trees::template leaves<kPitch, 1>(cas, min(tb + sub, t1 - 1), win, inv, leaf);
#pragma unroll
      for (int l = 0; l < G; ++l) {
        const float v = G == 1 ? leaf[0] : __shfl_sync(kFullWarp, leaf[0], l, G);
        if (tb + l < t1) ssum = ssum + static_cast<Acc>(v);
      }
    }
    push(valid && sub == 0 && ssum >= stage_thr, w, next, next_count);
  }
}

// The tile of block (blockIdx.x, blockIdx.y) in a grid that covers every
// window of the frame.
struct GridOrigin {
  __host__ dim3 grid(const Frame& f, int tile_h) const {
    return dim3((f.out_w + kTileW - 1) / kTileW, (f.out_h + tile_h - 1) / tile_h);
  }
  __device__ __forceinline__ bool operator()(const Frame&, int tile_h, int& r0, int& c0) const {
    r0 = blockIdx.y * tile_h;
    c0 = blockIdx.x * kTileW;
    return true;
  }
};

template <int kTileH>
constexpr size_t shared_bytes(int pitch, int win_h, int tiles) {
  // the patches, two window lists (16 bits an entry), the byte mask
  return static_cast<size_t>(tiles) * (kTileH + win_h) * pitch * 4 +
         static_cast<size_t>(kTileH) * kTileW * (2 + 2 + 1);
}

// Origin: grid(f, tile_h) on the host; on the device operator()(f, tile_h,
// r0, c0) gives the block's first window, or false when the block has no
// tile (the same answer in every thread of the block).
template <int kPitch, int kTileH, int kThreads, bool kStage, class Origin, class Trees, class Acc>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(Frame f, Cascade cas, int s0, int s1, Origin origin) {
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
  int r0, c0;
  if (!origin(f, kTileH, r0, c0)) return;
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
      inv[j] = Trees::kReadsInv && ok[j] ? f.inv[g0 + static_cast<size_t>(j) * f.out_w] : 1.0f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  int s = s0;
  if (kStage) {
    if (dense0) {
      Acc ssum[J];
#pragma unroll
      for (int j = 0; j < J; ++j) ssum[j] = static_cast<Acc>(0);
      const uint32_t* win = tile + row0 * kPitch + col;
      const int t1 = cas.stage_start[1];
      for (int t = cas.stage_start[0]; t < t1; ++t) {
        float leaf[J];
        Trees::template leaves<kPitch, J>(cas, t, win, inv, leaf);
#pragma unroll
        for (int j = 0; j < J; ++j) ssum[j] = ssum[j] + static_cast<Acc>(leaf[j]);
      }
      const Acc stage_thr = static_cast<Acc>(cas.stage_thr[0]);
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
        list_stage<kPitch, kThreads, 1, Trees, Acc>(f, cas, tile, list, n, next, filled, s, r0,
                                                    c0);
        break;
      case 2:
        list_stage<kPitch, kThreads, 2, Trees, Acc>(f, cas, tile, list, n, next, filled, s, r0,
                                                    c0);
        break;
      case 4:
        list_stage<kPitch, kThreads, 4, Trees, Acc>(f, cas, tile, list, n, next, filled, s, r0,
                                                    c0);
        break;
      case 8:
        list_stage<kPitch, kThreads, 8, Trees, Acc>(f, cas, tile, list, n, next, filled, s, r0,
                                                    c0);
        break;
      case 16:
        list_stage<kPitch, kThreads, 16, Trees, Acc>(f, cas, tile, list, n, next, filled, s, r0,
                                                     c0);
        break;
      default:
        list_stage<kPitch, kThreads, 32, Trees, Acc>(f, cas, tile, list, n, next, filled, s, r0,
                                                     c0);
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
template <int kPitch, int kTileH, int kThreads, bool kStage, class Trees, class Acc, class Origin>
int launch(const Frame& f, const Cascade& cas, int s0, int s1, const Origin& origin,
           cudaStream_t stream) {
  const auto kernel = tile_kernel<kPitch, kTileH, kThreads, kStage, Origin, Trees, Acc>;
  const size_t bytes = shared_bytes<kTileH>(kPitch, f.win_h, (kStage && f.has_tilt) ? 2 : 1);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = origin.grid(f, kTileH);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, kThreads, bytes, stream>>>(f, cas, s0, s1, origin);
  return static_cast<int>(cudaGetLastError());
}

// pitch is the one the records were resolved against (records.py's
// tile_pitch); a pitch that was not compiled is refused.
template <int kTileH, int kThreads, bool kStage, class Trees, class Acc, class Origin = GridOrigin>
int dispatch(int pitch, const Frame& f, const Cascade& cas, int s0, int s1,
             cudaStream_t stream, const Origin& origin = Origin()) {
  if (f.out_h <= 0 || f.out_w <= 0 || s0 < 0 || s1 < s0 || kTileW + f.win_w > pitch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (pitch) {
    case 152:
      return launch<152, kTileH, kThreads, kStage, Trees, Acc>(f, cas, s0, s1, origin, stream);
    case 200:
      return launch<200, kTileH, kThreads, kStage, Trees, Acc>(f, cas, s0, s1, origin, stream);
    case 264:
      return launch<264, kTileH, kThreads, kStage, Trees, Acc>(f, cas, s0, s1, origin, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dispatch with the stage sum in float or, when exact, in double.
template <int kTileH, int kThreads, bool kStage, class Trees, class Origin = GridOrigin>
int dispatch_exact(int exact, int pitch, const Frame& f, const Cascade& cas, int s0, int s1,
                   cudaStream_t stream, const Origin& origin = Origin()) {
  return exact ? dispatch<kTileH, kThreads, kStage, Trees, double>(pitch, f, cas, s0, s1, stream,
                                                                   origin)
               : dispatch<kTileH, kThreads, kStage, Trees, float>(pitch, f, cas, s0, s1, stream,
                                                                  origin);
}

// The node-tree instantiations live in their own translation units
// (tile_node.cu, tile_lbp.cu), built in parallel with the rest; front.cu
// and stage.cu hand them node and LBP cascades.
int front_node(int exact, int pitch, const Frame& f, const Cascade& cas, int s0, int s1,
               cudaStream_t stream);
int stage_node(int exact, int pitch, const Frame& f, const Cascade& cas, int s0, int s1,
               cudaStream_t stream);
int front_lbp(int exact, int pitch, const Frame& f, const Cascade& cas, int s0, int s1,
              cudaStream_t stream);
int stage_lbp(int exact, int pitch, const Frame& f, const Cascade& cas, int s0, int s1,
              cudaStream_t stream);

}  // namespace cct
