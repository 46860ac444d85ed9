// Tilted canvas integral: the 45-degree integral of every pyramid block of
// the pixel canvas, int32 with wrap-around mod 2^32.
//
// Replaces cascadeclassifier_tpu/detect/dense.py::canvas_tilted (an XLA
// lax.scan over the canvas rows in the JAX package, not a Pallas kernel;
// in plain torch it is a loop of ~8 launches per canvas row). With T[y]
// row y of the result on the columns [-p, W+p) and I[y][x] = px[y][x] for
// 1 <= x < W (0 elsewhere):
//   T[y][x] = T[y-1][x-1] + T[y-1][x+1] - T[y-2][x] + I[y][x] + I[y-1][x]
// with I[y-1] dropped when row y-1 is a block top, T[y] = 0 and both
// carries reset at a block top, and T = 0 outside the columns.
//
// The carries reset at every block top, so the segments of rows from one
// block top to the next are independent: one thread block per segment,
// threads across the columns, a loop over the segment's rows with the two
// carried rows in shared memory and one __syncthreads() per row. A thread
// writes its new value over T[y-2] in its own column, which no other
// thread reads, so the two buffers swap roles each row.
//
// The twin pads every segment by the same pad; a boundary error moves
// inward one column per row, so any p >= (segment rows + 1) gives the
// exact values on [0, W), and p = min(pad, rows + 1) equals the twin for
// every pad. All arithmetic is uint32, so the wrap-around is defined.
//
// Bound: device memory for the canvas read and the result write (both
// coalesced along rows), but the row loop is serial per segment: the time
// is that of the longest segment (the first pyramid level), one
// __syncthreads() and one global round trip per row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

// seg: (start, end, p, top) per segment; top: row `start` is a block top.
__global__ void tilted_kernel(const int32_t* __restrict__ px, int32_t* __restrict__ out,
                              int w, const int4* __restrict__ seg, int dmax) {
  extern __shared__ uint32_t buf[];
  const int4 sg = seg[blockIdx.x];
  const int d = w + 2 * sg.z;
  uint32_t* prev = buf;         // T[y-1] on the padded columns
  uint32_t* prev2 = buf + dmax;  // T[y-2]
  for (int k = threadIdx.x; k < d; k += blockDim.x) prev[k] = prev2[k] = 0u;
  __syncthreads();
  for (int y = sg.x; y < sg.y; ++y) {
    const size_t row = static_cast<size_t>(y) * w;
    if (y == sg.x && sg.w) {  // block top: a zero row, carries stay zero
      for (int x = threadIdx.x; x < w; x += blockDim.x) out[row + x] = 0;
      continue;
    }
    // I[y-1] is dropped after a block top; a segment that does not start
    // at a block top starts at row 0, with nothing above it
    const bool add_above = y > sg.x && !(y - 1 == sg.x && sg.w);
    for (int k = threadIdx.x; k < d; k += blockDim.x) {
      const int x = k - sg.z;
      uint32_t t = (k > 0 ? prev[k - 1] : 0u) + (k + 1 < d ? prev[k + 1] : 0u) - prev2[k];
      if (x >= 1 && x < w) {
        t += static_cast<uint32_t>(px[row + x]);
        if (add_above) t += static_cast<uint32_t>(px[row - w + x]);
      }
      prev2[k] = t;
      if (x >= 0 && x < w) out[row + x] = static_cast<int32_t>(t);
    }
    __syncthreads();
    uint32_t* tmp = prev;
    prev = prev2;
    prev2 = tmp;
  }
}

}  // namespace

// px, out (h, w) int32; seg (nseg, 4) int32 on the device; dmax = w + 2 *
// (largest p). Returns cudaGetLastError() after the launch.
extern "C" int cct_tilted(const void* px, void* out, int h, int w, const void* seg, int nseg,
                          int dmax, void* stream) {
  if (h <= 0 || w <= 0 || nseg <= 0 || dmax < w) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(dmax) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tilted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tilted_kernel<<<nseg, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(px), static_cast<int32_t*>(out), w,
      static_cast<const int4*>(seg), dmax);
  return static_cast<int>(cudaGetLastError());
}
