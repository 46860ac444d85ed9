// Canvas integrals: inclusive 2-D prefix sums of the pixel canvas and of
// its square, int32 with wrap-around mod 2^32.
//
// Replaces cascadeclassifier_tpu/detect/pallas_integral.py::make_integral_fn.
// The TPU kernel walks 256-row blocks in order and carries the column
// totals in VMEM; blocks on Hopper run in no order, so the carry becomes a
// separate pass:
//   1. row_scan      one block per row: block-wide scan of px and px^2
//                    along the row, written into the outputs
//   2. chunk_totals  one thread per (chunk of CH rows, column): the
//                    column sum of the row-scanned values in the chunk
//   3. chunk_carry   one thread per column: exclusive scan of the chunk
//                    totals down the column (in place)
//   4. col_apply     one thread per (chunk, column): running column sum
//                    from the carry, written in place
// All arithmetic is uint32 (signed overflow is undefined in C++); the
// result is the int64 cumsum narrowed to int32 bit for bit. No per-level
// top-row reset: every consumer takes 4-corner differences.
//
// Bound: device memory. At the 1080p canvas (11713 x 1921) the passes
// move about 0.8 GB (read px, write+read+read+write both outputs);
// coalesced row-major access in every pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kColThreads = 128;

__device__ __forceinline__ void warp_incl_scan(uint32_t& a, uint32_t& b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    uint32_t ta = __shfl_up_sync(0xffffffffu, a, o);
    uint32_t tb = __shfl_up_sync(0xffffffffu, b, o);
    if (lane >= o) {
      a += ta;
      b += tb;
    }
  }
}

__global__ void row_scan(const int32_t* __restrict__ px, uint32_t* __restrict__ sum,
                         uint32_t* __restrict__ sq, int w) {
  __shared__ uint32_t wa[kRowThreads / 32];
  __shared__ uint32_t wb[kRowThreads / 32];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(row) * w;
  uint32_t carry_a = 0, carry_b = 0;
  for (int c0 = 0; c0 < w; c0 += kRowThreads) {
    const int c = c0 + threadIdx.x;
    uint32_t a = 0, b = 0;
    if (c < w) {
      a = static_cast<uint32_t>(px[base + c]);
      b = a * a;
    }
    warp_incl_scan(a, b);
    if (lane == 31) {
      wa[wid] = a;
      wb[wid] = b;
    }
    __syncthreads();
    if (wid == 0) {
      uint32_t ta = lane < kRowThreads / 32 ? wa[lane] : 0u;
      uint32_t tb = lane < kRowThreads / 32 ? wb[lane] : 0u;
      warp_incl_scan(ta, tb);
      if (lane < kRowThreads / 32) {
        wa[lane] = ta;
        wb[lane] = tb;
      }
    }
    __syncthreads();
    if (wid > 0) {
      a += wa[wid - 1];
      b += wb[wid - 1];
    }
    if (c < w) {
      sum[base + c] = a + carry_a;
      sq[base + c] = b + carry_b;
    }
    carry_a += wa[kRowThreads / 32 - 1];
    carry_b += wb[kRowThreads / 32 - 1];
    __syncthreads();  // wa/wb are rewritten by the next tile
  }
}

__global__ void chunk_totals(const uint32_t* __restrict__ sum, const uint32_t* __restrict__ sq,
                             uint32_t* __restrict__ tot, int h, int w, int ch) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (col >= w) return;
  const int r1 = min(h, (k + 1) * ch);
  uint32_t a = 0, b = 0;
  for (int r = k * ch; r < r1; ++r) {
    const size_t i = static_cast<size_t>(r) * w + col;
    a += sum[i];
    b += sq[i];
  }
  const size_t nk = gridDim.y;
  tot[static_cast<size_t>(k) * w + col] = a;
  tot[(nk + k) * w + col] = b;
}

__global__ void chunk_carry(uint32_t* __restrict__ tot, int w, int nk) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= w) return;
  uint32_t a = 0, b = 0;
  for (int k = 0; k < nk; ++k) {
    const size_t ia = static_cast<size_t>(k) * w + col;
    const size_t ib = (static_cast<size_t>(nk) + k) * w + col;
    const uint32_t ta = tot[ia], tb = tot[ib];
    tot[ia] = a;
    tot[ib] = b;
    a += ta;
    b += tb;
  }
}

__global__ void col_apply(uint32_t* __restrict__ sum, uint32_t* __restrict__ sq,
                          const uint32_t* __restrict__ tot, int h, int w, int ch) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (col >= w) return;
  const size_t nk = gridDim.y;
  uint32_t a = tot[static_cast<size_t>(k) * w + col];
  uint32_t b = tot[(nk + k) * w + col];
  const int r1 = min(h, (k + 1) * ch);
  for (int r = k * ch; r < r1; ++r) {
    const size_t i = static_cast<size_t>(r) * w + col;
    a += sum[i];
    b += sq[i];
    sum[i] = a;
    sq[i] = b;
  }
}

}  // namespace

// px (h, w) int32; sum, sq (h, w) int32 outputs; tot: 2 * ceil(h/ch) * w
// uint32 scratch. Returns cudaGetLastError() after the launches.
extern "C" int cct_integral(const void* px, void* sum, void* sq, void* tot, int h,
                            int w, int ch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 0 || w <= 0 || ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nk = (h + ch - 1) / ch;
  auto* su = static_cast<uint32_t*>(sum);
  auto* qu = static_cast<uint32_t*>(sq);
  auto* tu = static_cast<uint32_t*>(tot);
  row_scan<<<h, kRowThreads, 0, s>>>(static_cast<const int32_t*>(px), su, qu, w);
  const dim3 grid((w + kColThreads - 1) / kColThreads, nk);
  chunk_totals<<<grid, kColThreads, 0, s>>>(su, qu, tu, h, w, ch);
  chunk_carry<<<(w + kColThreads - 1) / kColThreads, kColThreads, 0, s>>>(tu, w, nk);
  col_apply<<<grid, kColThreads, 0, s>>>(su, qu, tu, h, w, ch);
  return static_cast<int>(cudaGetLastError());
}
