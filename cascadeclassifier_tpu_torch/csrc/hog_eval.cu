// HOG responses: for k variables v = f*36 + cell*9 + bin and n windows, the
// bin's sum over the cell divided by the block's L1 norm plus 1e-3, 0 where
// the sum is not above 1e-3 (CvHOGEvaluator::operator(), HOGfeatures.h:
// 84-108), into a (k, n) f32 matrix.
//
// Replaces the JAX package's cell sums and block norms
// (cascadeclassifier_tpu/train/evaluators.py:296-310, an f32 einsum of a
// +-1 corner incidence matrix with the flattened histograms, and a dot for
// the norm) and ops/features.py:578 eval_hog: XLA programs, not Pallas
// kernels. The product reads 625-1089 columns a row of which 4 are
// non-zero, so this is a gather instead: each output reads the 4 corners
// of its bin's histogram and the 4 corners of the norm integral (cell 0's
// p0, cell 1's p1, cell 2's p2, cell 3's p3) and adds each set as
// ((p0 - p1) - p2) + p3, eval_hog's order, then divides (__fdiv_rn) and
// selects. Built with --fmad=false; every operation is the _rn intrinsic.
//
// Design: a thread an output, 32 windows x 8 variables a CTA; the window
// is the fast index, so the writes of a warp are one row segment. The
// corner reads of a warp hit 32 windows' histograms (9 (h+1)(w+1) floats
// apart): the L1 and L2 caches serve the 36 variables of a feature.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 32;
constexpr int kVar = 8;
constexpr int kBins = 9;
constexpr int kFeat = 36;

__device__ __forceinline__ float corners(const float* r, int a, int b, int c, int d) {
  return __fadd_rn(__fsub_rn(__fsub_rn(r[a], r[b]), r[c]), r[d]);
}

__global__ void __launch_bounds__(kWin * kVar)
hog_eval_kernel(const float* __restrict__ hist, const float* __restrict__ norm,
                const int32_t* __restrict__ cells, const int64_t* __restrict__ vars, int n,
                int p, int k, float* __restrict__ out) {
  const int i = blockIdx.x * kWin + threadIdx.x;
  const int v = blockIdx.y * kVar + threadIdx.y;
  if (i >= n || v >= k) return;
  const long long var = vars[v];
  const int f = static_cast<int>(var / kFeat), comp = static_cast<int>(var % kFeat);
  const int32_t* co = cells + static_cast<size_t>(f) * 16;
  const int32_t* c = co + (comp / kBins) * 4;
  const float cs = corners(hist + (static_cast<size_t>(i) * kBins + comp % kBins) * p,
                           c[0], c[1], c[2], c[3]);
  const float nm = corners(norm + static_cast<size_t>(i) * p, co[0], co[5], co[10], co[15]);
  const float eps = 1e-3f;
  out[static_cast<size_t>(v) * n + i] = cs > eps ? __fdiv_rn(cs, __fadd_rn(nm, eps)) : 0.f;
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int cct_hog_eval(const void* hist, const void* norm, const void* cells,
                            const void* vars, int n, int p, int k, void* out, void* stream) {
  if (n < 0 || k < 0 || p <= 0 || (k + kVar - 1) / kVar > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n + kWin - 1) / kWin, (k + kVar - 1) / kVar);
  hog_eval_kernel<<<grid, dim3(kWin, kVar), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hist), static_cast<const float*>(norm),
      static_cast<const int32_t*>(cells), static_cast<const int64_t*>(vars), n, p, k,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
