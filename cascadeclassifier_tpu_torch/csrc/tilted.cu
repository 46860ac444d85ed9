// Tilted canvas integral: the 45-degree integral of every pyramid block of
// the pixel canvas, int32 with wrap-around mod 2^32.
//
// Replaces cascadeclassifier_tpu/detect/dense.py::canvas_tilted (an XLA
// lax.scan over the canvas rows in the JAX package, not a Pallas kernel;
// in plain torch it is a loop of ~8 launches per canvas row). With T[y]
// row y of the result on the columns [-pad, W+pad) and I[y][x] = px[y][x]
// for 1 <= x < W (0 elsewhere):
//   T[y][x] = T[y-1][x-1] + T[y-1][x+1] - T[y-2][x] + I[y][x] + I[y-1][x]
// with I[y-1] dropped when row y-1 is a block top, T[y] = 0 and both
// carries reset at a block top, and T = 0 outside the columns.
//
// The carries reset at every block top, so the segments of rows from one
// block top to the next are independent, but inside a segment every row
// needs the row before: a chain as long as the tallest segment (the first
// pyramid level). One SM cannot move that level's pixels and results fast
// enough, so the chain is cut into pieces that many SMs work on at once:
//   chunks    a segment's computed rows go in chunks of kChunk rows, one
//             launch a chunk index: launch c takes chunk c of every segment
//             that has one, so the launches run in order on the stream and
//             everything inside a launch is independent
//   strips    inside a chunk a thread block owns kStrip consecutive columns
//             of the segment's padded row. A value moves one column a row,
//             so the block also computes kChunk more columns on each side:
//             what it computes there turns wrong from the outside in, one
//             column a row, and never reaches an owned column within the
//             chunk. Only owned columns are written
//   state     T[y-1] and T[y-2] of a chunk's last rows go to a state buffer
//             in device memory (owned columns, pad columns included), which
//             the next launch reads; two buffers, swapped each launch, so
//             that no block overwrites what another still has to read
//   steps     a thread holds one column: its two carries in registers and
//             its pixels of the whole chunk, loaded before the first step,
//             so no step waits for device memory. Its neighbours' values
//             come by shuffle, at a warp's ends through shared memory (two
//             buffers, swapped each row): one __syncthreads() a step
//   padding   with n computed rows in the segment, a value of row r reaches
//             a column of [0, W) in a later row only from within n - 1 - r
//             columns of it, and differs from zero only within r columns
//             of the pixels. So the segment is padded by p = min(pad,
//             (n - 1) / 2) columns with zeros outside [-p, W+p). On [0, W)
//             that gives the twin's values for every pad, also one too
//             small to be exact
// All arithmetic is uint32, so the wrap-around is defined.
//
// Bound: device memory, the canvas read once and the result written once.
// What keeps the kernel from it is the chain: ceil(n / kChunk) launches one
// after the other for the tallest segment, each kChunk steps of a barrier
// and a shuffle. Times on the card: PERF.md.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef CCT_TILTED_CHUNK
#define CCT_TILTED_CHUNK 64  // detect/tilted.py: CHUNK_ROWS
#endif
#ifndef CCT_TILTED_STRIP
#define CCT_TILTED_STRIP 256  // detect/tilted.py: STRIP_COLS
#endif

namespace {

constexpr int kChunk = CCT_TILTED_CHUNK;
constexpr int kStrip = CCT_TILTED_STRIP;
constexpr int kThreads = kStrip + 2 * kChunk;  // a column a thread
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullWarp = 0xffffffffu;
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps in one block");

// seg: (start, end, p, top) per segment; top: row `start` is a block top.
// items: (segment, first computed row of the chunk, first owned column, 0)
// per thread block. state_in, state_out: [segment][T[y-1], T[y-2]][dstate].
__global__ void __launch_bounds__(kThreads)
    tilted_kernel(const int32_t* __restrict__ px, int32_t* __restrict__ out, int w,
                  const int4* __restrict__ seg, const int4* __restrict__ items,
                  const uint32_t* __restrict__ state_in, uint32_t* __restrict__ state_out,
                  int dstate) {
  __shared__ uint32_t edge[2][kWarps][2];  // (first, last) value of every warp
  const int4 it = items[blockIdx.x];
  const int4 sg = seg[it.x];
  const int yb = sg.x + (sg.w ? 1 : 0);  // first computed row: nothing above it counts
  const int n = sg.y - yb;
  const int p = sg.z;
  const int d = w + 2 * p;  // the padded row, counted from column -p
  const int q0 = it.y;
  const int rows = min(kChunk, n - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k = it.z - kChunk + tid;  // the thread's column
  const int x = k - p;                // and where it lies on the canvas
  const bool inside = k >= 0 && k < d;
  const bool owned = inside && k >= it.z && k < it.z + kStrip;
  const bool on_canvas = owned && x >= 0 && x < w;
  const bool has_pixel = inside && x >= 1 && x < w;
  if (q0 == 0 && sg.w && on_canvas) out[static_cast<size_t>(sg.x) * w + x] = 0;  // the top row
  if (rows <= 0) return;  // a segment that is its top alone: the whole block leaves

  // pix[j + 1]: the pixel of the chunk's row j; pix[0]: of the row above it
  uint32_t pix[kChunk + 1];
  const int32_t* col = px + static_cast<size_t>(yb + q0) * w + x;
  pix[0] = (has_pixel && q0 > 0) ? static_cast<uint32_t>(__ldg(col - w)) : 0u;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    pix[j + 1] = (has_pixel && j < rows)
                     ? static_cast<uint32_t>(__ldg(col + static_cast<size_t>(j) * w))
                     : 0u;
  }
  uint32_t t1 = 0u, t2 = 0u;  // T[y-1], T[y-2] of the column
  const size_t st = static_cast<size_t>(it.x) * 2 * dstate + (inside ? k : 0);
  if (q0 > 0 && inside) {
    t1 = state_in[st];
    t2 = state_in[st + dstate];
  }
  if (lane == 0) edge[0][warp][0] = t1;
  if (lane == 31) edge[0][warp][1] = t1;
  __syncthreads();

  int32_t* dst = out + static_cast<size_t>(yb + q0) * w + x;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (j >= rows) break;  // the same row in every thread
    uint32_t left = __shfl_up_sync(kFullWarp, t1, 1);
    uint32_t right = __shfl_down_sync(kFullWarp, t1, 1);
    // the block's outermost columns take zeros: they are wrong from here on
    if (lane == 0) left = warp > 0 ? edge[j & 1][warp > 0 ? warp - 1 : 0][1] : 0u;
    if (lane == 31) right = warp + 1 < kWarps ? edge[j & 1][warp + 1 < kWarps ? warp + 1 : 0][0] : 0u;
    const uint32_t t0 = inside ? left + right - t2 + pix[j + 1] + pix[j] : 0u;
    t2 = t1;
    t1 = t0;
    if (lane == 0) edge[(j & 1) ^ 1][warp][0] = t0;
    if (lane == 31) edge[(j & 1) ^ 1][warp][1] = t0;
    if (on_canvas) dst[static_cast<size_t>(j) * w] = static_cast<int32_t>(t0);
    __syncthreads();
  }
  if (owned) {
    state_out[st] = t1;
    state_out[st + dstate] = t2;
  }
}

}  // namespace

// px, out (h, w) int32; seg (nseg, 4) and items (offsets[nlaunch], 4) int32
// on the device; offsets (nlaunch + 1) int32 on the host: launch c takes the
// items [offsets[c], offsets[c + 1]); state (2, nseg, 2, dstate) int32 on the
// device, dstate >= w + 2 * (largest p). Returns the first CUDA error.
extern "C" int cct_tilted(const void* px, void* out, int h, int w, const void* seg, int nseg,
                          const void* items, const int* offsets, int nlaunch, void* state,
                          int dstate, void* stream) {
  if (h <= 0 || w <= 0 || nseg <= 0 || nlaunch <= 0 || dstate < w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* st = static_cast<uint32_t*>(state);
  const size_t half = static_cast<size_t>(nseg) * 2 * dstate;
  for (int c = 0; c < nlaunch; ++c) {
    const int count = offsets[c + 1] - offsets[c];
    if (count <= 0) return static_cast<int>(cudaErrorInvalidValue);
    tilted_kernel<<<count, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(px), static_cast<int32_t*>(out), w,
        static_cast<const int4*>(seg), static_cast<const int4*>(items) + offsets[c],
        st + (c & 1) * half, st + ((c & 1) ^ 1) * half, dstate);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
