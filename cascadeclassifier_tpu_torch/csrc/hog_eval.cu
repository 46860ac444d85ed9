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
// non-zero, so this is a gather instead: a cell sum adds the 4 corners of
// its bin's histogram, the norm the 4 corners of the norm integral (cell
// 0's p0, cell 1's p1, cell 2's p2, cell 3's p3), each set as
// ((p0 - p1) - p2) + p3, eval_hog's order; then the division (__fdiv_rn)
// and the select. Built with --fmad=false; every operation is the _rn
// intrinsic.
//
// Bound: the 32-byte sectors that hold the corners read, each a load
// request of its own (a warp's 32 windows lie 9 (h+1)(w+1) floats apart),
// so the load unit's request rate, not device memory, is the limit.
//
// Design. A list of at most kDirectMax variables (the predictor's few used
// ones, mostly one a feature) takes one launch, a thread an output: its 4
// cell corners and 4 norm corners. A longer list (the trainer's blocks of
// whole features) takes two:
//   - the plan, one CTA, groups the k variables by feature in a scratch
//     the wrapper gives: counts by atomics, their scan (each feature's
//     start), then each variable's position and component scattered into
//     its feature's range by atomics (so the order within a feature is
//     any; no output depends on it). ops/hog.py::eval_plan is its plain
//     version, in sorted order;
//   - then a thread a (window, feature): a warp takes 32 windows, a CTA
//     kWarps warps of adjacent windows; the feature is the grid's fast
//     index, so the CTAs of one tile of windows run together and share its
//     histograms in L2. The warp
//       1. marks which of the feature's 36 variables are asked for;
//       2. loads the 4 norm corners once, then, for each bin asked for, the
//          points of the block's 3 x 3 corner grid that its cells need,
//          once, and writes each asked cell's response to shared memory
//          (36 x 32 floats a warp);
//       3. writes each variable of its range to the output row the caller
//          gave it, 32 adjacent windows a store.
// A feature's 36 variables so read 9 x 9 + 4 points, not 36 x 4 + 36 x 4.
// Each load request of a warp still touches 32 sectors (its 32 windows),
// and the rate of those requests bounds the kernel: its time follows the
// number of loads, not the warps in flight or whether the histograms sit
// in L2 (utils/tune_hog.py). The corner table is the catalog's: each
// feature's 4 cells a 2 x 2 grid that shares its corners
// (ops/hog.py::is_corner_grid, checked where the evaluator builds it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 32;
constexpr int kWarps = 4;  // warps a CTA, each 32 windows of one feature
constexpr int kBins = 9;
constexpr int kFeat = 36;
constexpr int kMaxGridY = 65535;
constexpr int kPlanThreads = 1024;
// lists this long or shorter take a thread an output and no plan
// (ops/hog.py::EVAL_DIRECT_MAX): about where the two gathers cross on the
// detector's batch of 8 192 windows (utils/tune_hog.py's sweep; on fewer
// windows they cross at longer lists)
constexpr int kDirectMax = 64;
constexpr int kDirectVars = 8;  // variables a CTA of the direct gather

// the 3 x 3 grid point of cell k's corner c, cells and corners in
// (top left, top right, bottom left, bottom right) order
__device__ __forceinline__ constexpr int point(int k, int c) {
  return (k / 2 + c / 2) * 3 + k % 2 + c % 2;
}

// the index into a feature's 16 corner offsets (cell * 4 + corner) that
// defines grid point q: cell 0's corners, then the new ones of cells 1-3
__device__ __forceinline__ constexpr int defining(int q) {
  return 4 * (2 * (q / 3 == 2) + (q % 3 == 2)) + 2 * (q / 3 - (q / 3 == 2)) + q % 3 -
         (q % 3 == 2);
}

__device__ __forceinline__ float corners(float a, float b, float c, float d) {
  return __fadd_rn(__fsub_rn(__fsub_rn(a, b), c), d);
}

// The plan: starts (nf + 1) each feature's range in pos and comp (k), a
// variable's position in the caller's list and its component (cell * 9 +
// bin); cursor (nf) scratch. Ids outside [0, 36 nf) are left out.
__global__ void __launch_bounds__(kPlanThreads)
hog_eval_plan_kernel(const int64_t* __restrict__ ids, int k, int nf, int32_t* __restrict__ starts,
                     int32_t* __restrict__ cursor, int32_t* __restrict__ pos,
                     int32_t* __restrict__ comp) {
  __shared__ int32_t warp_sums[kPlanThreads / 32];
  const int t = threadIdx.x, lane = t % 32, wp = t / 32;
  for (int f = t; f <= nf; f += kPlanThreads) starts[f] = 0;
  __syncthreads();
  const long long vars = static_cast<long long>(nf) * kFeat;
  for (int j = t; j < k; j += kPlanThreads) {
    const long long v = ids[j];
    if (v >= 0 && v < vars) atomicAdd(starts + v / kFeat + 1, 1);
  }
  __syncthreads();
  // the exclusive scan of the counts, a chunk a thread
  const int chunk = (nf + kPlanThreads - 1) / kPlanThreads, lo = min(nf, t * chunk) + 1,
            hi = min(nf, (t + 1) * chunk) + 1;
  int sum = 0;
  for (int f = lo; f < hi; ++f) sum += starts[f];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[wp] = incl;
  __syncthreads();
  int before = incl - sum;
  for (int q = 0; q < wp; ++q) before += warp_sums[q];
  for (int f = lo; f < hi; ++f) {
    before += starts[f];
    starts[f] = before;
  }
  __syncthreads();
  for (int f = t; f < nf; f += kPlanThreads) cursor[f] = starts[f];
  __syncthreads();
  for (int j = t; j < k; j += kPlanThreads) {
    const long long v = ids[j];
    if (v < 0 || v >= vars) continue;
    const int f = static_cast<int>(v / kFeat), s = atomicAdd(cursor + f, 1);
    pos[s] = j;
    comp[s] = static_cast<int>(v - static_cast<long long>(f) * kFeat);
  }
}

// One warp's 32 windows (window i its lane's, valid when i < n) and
// feature f, whose entries are [lo, hi) of pos and comp: steps 1-3 of the
// design; r is the warp's 36 x 32 responses.
__device__ __forceinline__ void feature_responses(
    const float* __restrict__ hist, const float* __restrict__ norm,
    const int32_t* __restrict__ cells, const int32_t* __restrict__ pos,
    const int32_t* __restrict__ comp, int lo, int hi, int f, int i, bool valid, int n, int p,
    float* r, float* __restrict__ out) {
  const int lane = threadIdx.x;
  // 1. the variables asked for, a bit each
  unsigned long long asked = 0;
  for (int j = lo; j < hi; ++j) asked |= 1ull << comp[j];
  int o[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int4 q =
        __ldg(reinterpret_cast<const int4*>(cells + static_cast<size_t>(f) * 16) + c);
    o[4 * c] = q.x, o[4 * c + 1] = q.y, o[4 * c + 2] = q.z, o[4 * c + 3] = q.w;
  }
  int pt[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) pt[q] = o[defining(q)];
  // 2. the norm (its loads in flight with the first bin's), then each bin
  // asked for
  float nc[4] = {0.f, 0.f, 0.f, 0.f};
  if (valid) {
    const float* nr = norm + static_cast<size_t>(i) * p;
    nc[0] = __ldg(nr + o[0]), nc[1] = __ldg(nr + o[5]), nc[2] = __ldg(nr + o[10]),
    nc[3] = __ldg(nr + o[15]);
  }
  float den = 0.f;
  bool added = false;
#pragma unroll 1
  for (int b = 0; b < kBins; ++b) {
    const unsigned cm = static_cast<unsigned>((asked >> b) & 1) |
                        static_cast<unsigned>((asked >> (b + 9)) & 1) << 1 |
                        static_cast<unsigned>((asked >> (b + 18)) & 1) << 2 |
                        static_cast<unsigned>((asked >> (b + 27)) & 1) << 3;
    if (!cm) continue;
    const float* hb = hist + (static_cast<size_t>(i) * kBins + b) * p;
    unsigned need = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (cm >> k & 1)
#pragma unroll
        for (int c = 0; c < 4; ++c) need |= 1u << point(k, c);
    float v[9];
#pragma unroll
    for (int q = 0; q < 9; ++q)
      v[q] = valid && (need >> q & 1) ? __ldg(hb + pt[q]) : 0.f;
    if (!added) den = __fadd_rn(corners(nc[0], nc[1], nc[2], nc[3]), 1e-3f), added = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(cm >> k & 1)) continue;
      const float cs = corners(v[point(k, 0)], v[point(k, 1)], v[point(k, 2)], v[point(k, 3)]);
      r[(k * kBins + b) * kWin + lane] = cs > 1e-3f ? __fdiv_rn(cs, den) : 0.f;
    }
  }
  __syncwarp();
  // 3. each variable to its row
  if (valid)
    for (int j = lo; j < hi; ++j)
      out[static_cast<size_t>(pos[j]) * n + i] = r[comp[j] * kWin + lane];
  __syncwarp();
}

__global__ void __launch_bounds__(kWin * kWarps)
hog_eval_kernel(const float* __restrict__ hist, const float* __restrict__ norm,
                const int32_t* __restrict__ cells, const int32_t* __restrict__ starts,
                const int32_t* __restrict__ pos, const int32_t* __restrict__ comp, int n, int p,
                int nf, float* __restrict__ out) {
  __shared__ float resp[kWarps][kFeat][kWin];
  const int tiles = (n + kWin * kWarps - 1) / (kWin * kWarps);
  const int f = blockIdx.x, lo = starts[f], hi = starts[f + 1];
  if (lo == hi) return;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int i = (tile * kWarps + threadIdx.y) * kWin + threadIdx.x;
    feature_responses(hist, norm, cells, pos, comp, lo, hi, f, i, i < n, n, p,
                      resp[threadIdx.y][0], out);
  }
}

// A short list: a thread an output, 32 windows x kDirectVars variables a
// CTA, each output's 4 cell corners and 4 norm corners read for it.
__global__ void __launch_bounds__(kWin * kDirectVars)
hog_eval_direct_kernel(const float* __restrict__ hist, const float* __restrict__ norm,
                       const int32_t* __restrict__ cells, const int64_t* __restrict__ ids, int n,
                       int p, int k, float* __restrict__ out) {
  const int i = blockIdx.x * kWin + threadIdx.x;
  const int v = blockIdx.y * kDirectVars + threadIdx.y;
  if (i >= n || v >= k) return;
  const long long var = ids[v];
  const int f = static_cast<int>(var / kFeat), c = static_cast<int>(var % kFeat);
  const int32_t* o = cells + static_cast<size_t>(f) * 16;
  const int32_t* q = o + (c / kBins) * 4;
  const float* hb = hist + (static_cast<size_t>(i) * kBins + c % kBins) * p;
  const float* nr = norm + static_cast<size_t>(i) * p;
  const float cs = corners(__ldg(hb + q[0]), __ldg(hb + q[1]), __ldg(hb + q[2]), __ldg(hb + q[3]));
  const float nm =
      corners(__ldg(nr + o[0]), __ldg(nr + o[5]), __ldg(nr + o[10]), __ldg(nr + o[15]));
  out[static_cast<size_t>(v) * n + i] = cs > 1e-3f ? __fdiv_rn(cs, __fadd_rn(nm, 1e-3f)) : 0.f;
}

}  // namespace

// ids (k,) int64; scratch: 2 nf + 1 + 2 k int32 for the plan when k >
// kDirectMax (else unused, may be null). Returns cudaGetLastError() after
// the launches.
extern "C" int cct_hog_eval(const void* hist, const void* norm, const void* cells,
                            const void* ids, int n, int p, int nf, int k, void* scratch,
                            void* out, void* stream) {
  if (n < 0 || k < 0 || p <= 0 || nf < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || k == 0 || nf == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hist);
  const float* nm = static_cast<const float*>(norm);
  const int32_t* c = static_cast<const int32_t*>(cells);
  const int64_t* id = static_cast<const int64_t*>(ids);
  float* o = static_cast<float*>(out);
  if (k <= kDirectMax) {
    const dim3 grid((n + kWin - 1) / kWin, (k + kDirectVars - 1) / kDirectVars);
    hog_eval_direct_kernel<<<grid, dim3(kWin, kDirectVars), 0, st>>>(h, nm, c, id, n, p, k, o);
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles = (n + kWin * kWarps - 1) / (kWin * kWarps);
  const dim3 grid(nf, tiles < kMaxGridY ? tiles : kMaxGridY);
  int32_t* starts = static_cast<int32_t*>(scratch);
  int32_t* cursor = starts + nf + 1;
  int32_t* pos = cursor + nf;
  int32_t* comp = pos + k;
  hog_eval_plan_kernel<<<1, kPlanThreads, 0, st>>>(id, k, nf, starts, cursor, pos, comp);
  hog_eval_kernel<<<grid, dim3(kWin, kWarps), 0, st>>>(h, nm, c, starts, pos, comp, n, p, nf, o);
  return static_cast<int>(cudaGetLastError());
}
