// Survivor patch gather: for n window slots (r, c) and a live count cnt,
// copy each window's (ph x pw) integral patch into one row of an (n, ph*pw)
// int32 matrix; rows >= cnt are zero.
//
// Replaces cascadeclassifier_tpu/detect/compact.py::make_pallas_patchify
// with its emit="i32" contract. The TPU kernel DMAs 8-aligned slabs and
// lane-rolls each patch into 32-lane slots because Mosaic has no dynamic
// lane offsets; here it is a plain gather, one block per window, threads
// striding over the patch cells. The bf16 limb planes the TPU's MXU tail
// needs are not produced: the tail reads int32.
//
// Bound: device memory latency of scattered 84-byte patch rows; each
// window's rows are contiguous in the canvas, so a warp's loads fall in a
// handful of segments. Coordinates of live slots must lie in
// [0, canvas_h - ph] x [0, canvas_w - pw]; out-of-range cells read as 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void patchify_kernel(const int32_t* __restrict__ canvas, int canvas_h,
                                int canvas_w, const int32_t* __restrict__ rr,
                                const int32_t* __restrict__ cc, int cnt, int ph, int pw,
                                int32_t* __restrict__ out) {
  const int wdx = blockIdx.x;
  const int p = ph * pw;
  int32_t* dst = out + static_cast<size_t>(wdx) * p;
  if (wdx >= cnt) {
    for (int k = threadIdx.x; k < p; k += blockDim.x) dst[k] = 0;
    return;
  }
  const int r = rr[wdx];
  const int c = cc[wdx];
  for (int k = threadIdx.x; k < p; k += blockDim.x) {
    const int y = r + k / pw;
    const int x = c + k % pw;
    const bool ok = y >= 0 && y < canvas_h && x >= 0 && x < canvas_w;
    dst[k] = ok ? canvas[static_cast<size_t>(y) * canvas_w + x] : 0;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int cct_patchify(const void* canvas, int canvas_h, int canvas_w, const void* r,
                            const void* c, int n, int cnt, int ph, int pw, void* out,
                            void* stream) {
  if (n < 0 || ph <= 0 || pw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  patchify_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(canvas), canvas_h, canvas_w,
      static_cast<const int32_t*>(r), static_cast<const int32_t*>(c), cnt, ph, pw,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
