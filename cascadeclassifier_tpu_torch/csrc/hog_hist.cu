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
// Bound: the integrals are written once, 40 (h+1)(w+1) bytes a window
// against h w bytes read, so the kernel is bound by device memory writes.
//
// Design: a CTA takes one window and a group of `channels` of the 10
// channels (the 9 bins, then the norm), ops/hog.py::hist_plan's choice for
// the shared-memory budget (a grid row a group). Each channel plane,
// (h+1) rows of an odd stride S (w+1, or w+2 when w+1 is even, so that
// neither pass conflicts on banks), is built in shared memory:
//   1. a thread a pixel reads the window's 4 neighbours and the bin table
//      and writes the pixel's value into every plane of the group;
//   2. a thread a (plane, row) scans the row in place; lanes are rows,
//      S floats apart;
//   3. a thread a (plane, column) scans the column in place; lanes are
//      adjacent columns;
//   4. the planes go to device memory once, as at most two runs that are
//      contiguous there: the group's histogram planes, and the norm plane.
//      Each run sits in shared memory at the same address modulo 16 bytes
//      as its destination, so its aligned body goes out in one bulk copy
//      (cp.async.bulk) issued by one thread, with scalar heads and tails;
//      with the padded stride the run is gathered row by row in 4-byte
//      stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 9;
constexpr int kChannels = kBins + 1;
constexpr int kRange = 511;
constexpr int kBase = 16;  // XLA:CPU's run length for jnp.cumsum
constexpr int kMaxSide = kBase * kBase;
constexpr int kMaxShared = 227 * 1024;
constexpr int kMaxThreads = 1024;
constexpr int kSlack = 4;  // floats a run may be shifted by to match its destination

// Floats of shared memory a CTA takes: its planes and a slack a run; the
// same sum as ops/hog.py::shared_bytes.
__host__ __device__ inline long long shared_floats(int channels, int plane) {
  return static_cast<long long>(channels) * plane + 2 * kSlack;
}

// The first float at or after slot that agrees with dst modulo 4 floats.
__device__ __forceinline__ int align(int slot, long long dst) {
  return slot + ((static_cast<int>(dst & 3) - (slot & 3)) & 3);
}

// Adds a line of len floats, step floats apart, in place: runs of 16 from
// 0, each run's sums plus the exclusive prefix of the run totals.
__device__ __forceinline__ void scan_line(float* p, int step, int len) {
  float carry = 0.f;
  for (int x0 = 0; x0 < len; x0 += kBase) {
    const int m = min(kBase, len - x0);
    float v[kBase];
#pragma unroll
    for (int i = 0; i < kBase; ++i) v[i] = i < m ? p[(x0 + i) * step] : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kBase; ++i) {
      acc = __fadd_rn(acc, v[i]);  // the padding adds +0 to a sum >= +0
      v[i] = x0 == 0 ? acc : __fadd_rn(acc, carry);
    }
#pragma unroll
    for (int i = 0; i < kBase; ++i)
      if (i < m) p[(x0 + i) * step] = v[i];
    carry = x0 == 0 ? acc : __fadd_rn(carry, acc);
  }
}

// Copies len floats from shared memory to device memory; src and dst
// agree modulo 16 bytes.
__device__ __forceinline__ void copy_run(float* __restrict__ dst, const float* src, int len) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int misaligned = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  const int head = min(len, ((16 - misaligned) & 15) / 4);
  const int body = (len - head) / 4;  // 16-byte blocks
  for (int i = t; i < head; i += nt) dst[i] = src[i];
  if (body > 0 && t == 0) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src + head));
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst + head),
        "r"(s), "r"(body * 16)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  for (int i = head + 4 * body + t; i < len; i += nt) dst[i] = src[i];
}

// Copies `planes` planes of (h + 1) rows from shared memory, where their
// rows are `stride` floats apart, to device memory: copy_run when stride is
// w + 1, else one output row after another.
__device__ __forceinline__ void copy_planes(float* __restrict__ dst, const float* src,
                                            int planes, int h, int w, int stride) {
  const int t = threadIdx.x, nt = blockDim.x, w1 = w + 1;
  if (stride == w1) {
    copy_run(dst, src, planes * (h + 1) * w1);
    return;
  }
  for (int r = t / 32; r < planes * (h + 1); r += nt / 32)
    for (int x = t % 32; x < w1; x += 32) dst[r * w1 + x] = src[r * stride + x];
}

// Window blockIdx.x, channels [c0, c0 + channels) of grid row blockIdx.y.
// Shared memory holds the group's histogram planes as one run, then the
// norm plane, each run placed where its destination's address modulo 16
// bytes says.
__global__ void __launch_bounds__(kMaxThreads)
hog_hist_kernel(const uint8_t* __restrict__ img, const uint8_t* __restrict__ table, int h, int w,
                int stride, int channels, float* __restrict__ hist, float* __restrict__ norm) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int t = threadIdx.x, nt = blockDim.x, s = blockIdx.x;
  const int c0 = blockIdx.y * channels, c1 = min(kChannels, c0 + channels), nc = c1 - c0;
  const int w1 = w + 1, hw = h * w, pplane = (h + 1) * stride, p = (h + 1) * w1;
  const int nb = max(0, min(c1, kBins) - c0);  // bins in the group; the norm if c1 == 10
  const long long hdst = (static_cast<long long>(s) * kBins + c0) * p;
  const long long ndst = static_cast<long long>(s) * p;
  const int hbase = align(0, hdst), nbase = align(hbase + nb * pplane, ndst);
  // plane j of the group: its bins, then the norm
  const auto plane = [=](int j) { return j < nb ? hbase + j * pplane : nbase; };

  // 1. each pixel's value into every plane of the group; row 0 and
  // column 0 of each plane are zero
  const uint8_t* px = img + static_cast<size_t>(s) * hw;
  for (int i = t; i < hw; i += nt) {
    const int y = i / w, x = i - y * w;
    const int gx = static_cast<int>(__ldg(px + y * w + min(x + 1, w - 1))) -
                   __ldg(px + y * w + max(x - 1, 0));
    const int gy = static_cast<int>(__ldg(px + min(y + 1, h - 1) * w + x)) -
                   __ldg(px + max(y - 1, 0) * w + x);
    const float mag = __fsqrt_rn(static_cast<float>(gx * gx + gy * gy));
    const int bin = __ldg(table + (gx + 255) * kRange + gy + 255);
    const int at = (y + 1) * stride + 1 + x;
    for (int j = 0; j < nc; ++j)
      sm[plane(j) + at] = (c0 + j == kBins || bin == c0 + j) ? mag : 0.f;
  }
  for (int i = t; i < nc * (w1 + h); i += nt) {
    const int j = i / (w1 + h), e = i - j * (w1 + h);
    sm[plane(j) + (e < w1 ? e : (e - w1 + 1) * stride)] = 0.f;
  }
  __syncthreads();
  // 2. rows
  for (int i = t; i < nc * h; i += nt) {
    const int j = i / h, y = i - j * h;
    scan_line(sm + plane(j) + (y + 1) * stride + 1, 1, w);
  }
  __syncthreads();
  // 3. columns
  for (int i = t; i < nc * w; i += nt) {
    const int j = i / w, x = i - j * w;
    scan_line(sm + plane(j) + stride + 1 + x, stride, h);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  // 4. the runs to device memory
  if (nb) copy_planes(hist + hdst, sm + hbase, nb, h, w, stride);
  if (c1 == kChannels) copy_planes(norm + ndst, sm + nbase, 1, h, w, stride);
  if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

}  // namespace

// channels and threads are ops/hog.py::hist_plan's. Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue for a side
// above 256, a plan out of range, or one whose planes do not fit a CTA's
// shared memory.
extern "C" int cct_hog_hist(const void* img, const void* table, int n, int h, int w,
                            int channels, int threads, void* hist, void* norm, void* stream) {
  const int stride = (w + 1) % 2 ? w + 1 : w + 2;
  const long long shared =
      static_cast<long long>(sizeof(float)) * shared_floats(channels, (h + 1) * stride);
  if (n < 0 || h <= 0 || w <= 0 || h > kMaxSide || w > kMaxSide || channels <= 0 ||
      channels > kChannels || threads <= 0 || threads > kMaxThreads || threads % 32 ||
      shared > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (shared > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(hog_hist_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(n), (kChannels + channels - 1) / channels);
  hog_hist_kernel<<<grid, threads, static_cast<size_t>(shared),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<const uint8_t*>(table), h, w, stride,
      channels, static_cast<float*>(hist), static_cast<float*>(norm));
  return static_cast<int>(cudaGetLastError());
}
