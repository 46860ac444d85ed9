// HOG integral histograms: for each uint8 window of an (n, h, w) batch, the
// integral images of the gradient magnitude per orientation bin, hist
// (n, 9, h+1, w+1) f32, and in total, norm (n, h+1, w+1) f32.
//
// Replaces cascadeclassifier_tpu/ops/features.py:537 hog_integral_histogram
// (an XLA program, not a Pallas kernel): central differences with
// replicated borders, mag = sqrt(gx^2 + gy^2), the bin of the atan2 angle,
// then jnp.cumsum along W and along H. The bits are XLA:CPU's:
//   - gx, gy are integers in [-255, 255], so the bin is read from a
//     511 x 511 table built on the host (ops/hog.py::bin_table) instead of
//     computing atan2 here, whose rounding near the 9 bin edges need not
//     be XLA:CPU's;
//   - gx^2 + gy^2 is an exact integer below 2^24 and its root is taken
//     correctly rounded (__fsqrt_rn), as XLA:CPU takes it;
//   - each cumsum adds sequential runs of 16 from 0 and then each run's
//     exclusive prefix of the run totals, a sequential run itself
//     (train/split.py::scan_cumsum); for a side of at most 256 that is
//     the whole order. Every add is __fadd_rn and the file is built with
//     --fmad=false.
//
// Design: one CTA a window. The magnitudes and bins go to shared memory;
// a thread a (channel, row) writes the row scans into the output, then,
// after a barrier, a thread a (channel, column) scans each column of the
// output in place (coalesced across the threads of a warp). The 10
// channels are the 9 bins and the norm.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 9;
constexpr int kChannels = kBins + 1;
constexpr int kRange = 511;
constexpr int kBase = 16;  // XLA:CPU's run length for jnp.cumsum
constexpr int kMaxSide = kBase * kBase;
constexpr int kMaxShared = 227 * 1024;

__device__ __forceinline__ float* channel(float* hs, float* ns, int c, int plane) {
  return c < kBins ? hs + static_cast<size_t>(c) * plane : ns;
}

__global__ void __launch_bounds__(kThreads)
hog_hist_kernel(const uint8_t* __restrict__ img, const uint8_t* __restrict__ table, int h,
                int w, float* __restrict__ hist, float* __restrict__ norm) {
  extern __shared__ float smem[];
  float* mag = smem;                                      // h * w
  uint8_t* bin = reinterpret_cast<uint8_t*>(mag + h * w);  // h * w
  const int s = blockIdx.x;
  const uint8_t* px = img + static_cast<size_t>(s) * h * w;
  for (int i = threadIdx.x; i < h * w; i += blockDim.x) {
    const int y = i / w, x = i % w;
    const int gx = static_cast<int>(px[y * w + min(x + 1, w - 1)]) - px[y * w + max(x - 1, 0)];
    const int gy = static_cast<int>(px[min(y + 1, h - 1) * w + x]) - px[max(y - 1, 0) * w + x];
    mag[i] = __fsqrt_rn(static_cast<float>(gx * gx + gy * gy));
    bin[i] = table[(gx + 255) * kRange + gy + 255];
  }
  const int wp = w + 1, plane = (h + 1) * wp;
  float* hs = hist + static_cast<size_t>(s) * kBins * plane;
  float* ns = norm + static_cast<size_t>(s) * plane;
  // row 0 and column 0 of every channel are zero
  for (int i = threadIdx.x; i < kChannels * (wp + h); i += blockDim.x) {
    const int c = i / (wp + h), j = i % (wp + h);
    channel(hs, ns, c, plane)[j < wp ? j : (j - wp + 1) * wp] = 0.f;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kChannels * h; t += blockDim.x) {
    const int c = t / h, y = t % h;
    float* out = channel(hs, ns, c, plane) + (y + 1) * wp + 1;
    const float* m = mag + y * w;
    const uint8_t* b = bin + y * w;
    float carry = 0.f;
    for (int x0 = 0; x0 < w; x0 += kBase) {
      float acc = 0.f;
      for (int x = x0; x < min(x0 + kBase, w); ++x) {
        acc = __fadd_rn(acc, (c == kBins || b[x] == c) ? m[x] : 0.f);
        out[x] = x0 == 0 ? acc : __fadd_rn(acc, carry);
      }
      carry = x0 == 0 ? acc : __fadd_rn(carry, acc);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kChannels * w; t += blockDim.x) {
    const int c = t / w, x = t % w;
    float* out = channel(hs, ns, c, plane) + wp + 1 + x;
    float carry = 0.f;
    for (int y0 = 0; y0 < h; y0 += kBase) {
      float acc = 0.f;
      for (int y = y0; y < min(y0 + kBase, h); ++y) {
        acc = __fadd_rn(acc, out[y * wp]);
        out[y * wp] = y0 == 0 ? acc : __fadd_rn(acc, carry);
      }
      carry = y0 == 0 ? acc : __fadd_rn(carry, acc);
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// side above 256 or a window whose magnitudes and bins exceed shared memory.
extern "C" int cct_hog_hist(const void* img, const void* table, int n, int h, int w,
                            void* hist, void* norm, void* stream) {
  const size_t shared = static_cast<size_t>(h) * w * (sizeof(float) + 1);
  if (n < 0 || h <= 0 || w <= 0 || h > kMaxSide || w > kMaxSide || shared > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (shared > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(hog_hist_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hog_hist_kernel<<<n, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<const uint8_t*>(table), h, w,
      static_cast<float*>(hist), static_cast<float*>(norm));
  return static_cast<int>(cudaGetLastError());
}
