// Stage kernel: stump-Haar stages [s0, s1), upright and tilted features,
// at every alive window of the canvas, with stage 0's pass mask collected.
//
// Replaces cascadeclassifier_tpu/detect/pallas_stage.py::
// make_pallas_chunk_fn (the engine="pallas" kernel). Its output contract:
//   alive'  = alive AND every stage in [s0, s1) passed
//   passed0 = stage 0's pass mask at EVERY window when s0 == 0 (the walk's
//             skip trigger, collect_passed0), zeros otherwise
// The TPU kernel's layout workarounds are not carried over: the tilted
// canvas needs no TILT_BIAS lane offset (x - h >= 0 is checked at pack
// time), rows need no 8-aligned loads, lanes no rolls, and the stages need
// no SMEM-sized chunking, so one launch may take the whole cascade.
//
// One thread per canvas window: stage 0 first when s0 == 0 (for every
// window, alive or not, as the TPU kernel does), then the remaining
// stages in order for an alive window until the first it fails. Per tree,
// as dense_stage_haar(exact=False) does:
//   rect  upright: C[y][x] - C[y][x+w] - C[y+h][x] + C[y+h][x+w] on the
//         integral canvas; tilted: T[y][x] - T[y+h][x-h] - T[y+w][x+w]
//         + T[y+w+h][x+w-h] on the tilted canvas (uint32 wrap, then read
//         as int32, as the reference's int32 arithmetic wraps)
//   raw   = f32(rect0)*w0 + f32(rect1)*w1 (+ ...), rects of weight 0 skipped
//   val   = raw * inv_nf;  leaf = val < thr ? left : right
//   ssum  = ssum + leaf, one add per tree in tree order
// and the stage passes iff ssum >= stage_thr. Built with --fmad=false so
// no multiply-add is contracted into an FMA (the reference rounds twice).
// front.cu does the same arithmetic for upright trees; sharing one device
// function with it made the front kernel ~10% slower on the H100, so the
// two keep their own copies.
//
// Tree parameters live in device buffers (rects (T,3,4) int32, weights
// (T,3) f32, (thr, left, right) (T,3) f32, tilted (T) int32, stage_start
// (S+1), stage_thr (S)), so one binary serves every cascade; every thread
// of a warp reads the same parameter, which the cache broadcasts.
// PackedCascade checks at pack time that every corner of every rect lies
// inside the window, so no read leaves the canvas and nothing is clamped.
//
// Bound: canvas gathers. Stage 0 reads 4 corners per rect of its trees at
// every window; later stages only at survivors. Neighbouring threads read
// neighbouring columns of both canvases, so loads coalesce and a window's
// (win_h + 1) x (win_w + 1) patch of each canvas stays in L1/L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Trees {
  const int4* __restrict__ rects;
  const float* __restrict__ wts;
  const float* __restrict__ tparam;
  const int32_t* __restrict__ tilted;
  const int32_t* __restrict__ stage_start;
  const float* __restrict__ stage_thr;
};

__device__ __forceinline__ bool stage_passes(const Trees& tr, int s, const uint32_t* sb,
                                             const uint32_t* tb, int cw, float inv_nf) {
  float ssum = 0.0f;
  const int t1 = tr.stage_start[s + 1];
  for (int t = tr.stage_start[s]; t < t1; ++t) {
    const bool tilted = tr.tilted[t] != 0;
    float raw = 0.0f;
    bool first = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float wt = tr.wts[t * 3 + k];
      if (wt == 0.0f) continue;
      const int4 q = tr.rects[t * 3 + k];  // x, y, w, h
      uint32_t u;
      if (tilted) {
        const uint32_t* p0 = tb + static_cast<size_t>(q.y) * cw;  // row y
        const uint32_t* p1 = p0 + static_cast<size_t>(q.w) * cw;  // row y + h
        const uint32_t* p2 = p0 + static_cast<size_t>(q.z) * cw;  // row y + w
        const uint32_t* p3 = p1 + static_cast<size_t>(q.z) * cw;  // row y + w + h
        u = p0[q.x] - p1[q.x - q.w] - p2[q.x + q.z] + p3[q.x + q.z - q.w];
      } else {
        const uint32_t* p0 = sb + static_cast<size_t>(q.y) * cw + q.x;
        const uint32_t* p1 = p0 + static_cast<size_t>(q.w) * cw;
        u = p0[0] - p0[q.z] - p1[0] + p1[q.z];
      }
      const float term = static_cast<float>(static_cast<int32_t>(u)) * wt;
      raw = first ? term : raw + term;
      first = false;
    }
    const float val = raw * inv_nf;
    const float* tp = tr.tparam + t * 3;  // thr, left, right
    ssum = ssum + (val < tp[0] ? tp[1] : tp[2]);
  }
  return ssum >= tr.stage_thr[s];
}

__global__ void stage_kernel(const int32_t* __restrict__ sum, const int32_t* __restrict__ tilt,
                             int canvas_w, const float* __restrict__ inv,
                             const uint8_t* __restrict__ alive_in,
                             uint8_t* __restrict__ alive_out, uint8_t* __restrict__ passed0,
                             int out_h, int out_w, Trees tr, int s0, int s1) {
  const long long n = static_cast<long long>(out_h) * out_w;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = static_cast<int>(i / out_w);
  const int c = static_cast<int>(i - static_cast<long long>(r) * out_w);
  const size_t off = static_cast<size_t>(r) * canvas_w + c;
  const uint32_t* sb = reinterpret_cast<const uint32_t*>(sum) + off;
  const uint32_t* tb = reinterpret_cast<const uint32_t*>(tilt) + off;
  const float inv_nf = inv[i];
  bool alive = alive_in[i] != 0;
  bool p0 = false;
  int s = s0;
  if (s0 == 0 && s1 > 0) {
    p0 = stage_passes(tr, 0, sb, tb, canvas_w, inv_nf);
    alive = alive && p0;
    s = 1;
  }
  for (; s < s1 && alive; ++s) alive = stage_passes(tr, s, sb, tb, canvas_w, inv_nf);
  alive_out[i] = alive;
  passed0[i] = p0;
}

}  // namespace

// sum, tilt: (out_h + win_h, canvas_w) int32 canvases (tilt may equal sum
// when no tree is tilted); inv (out_h, out_w) f32; alive_in, alive_out,
// passed0 (out_h, out_w) u8. Returns cudaGetLastError() after the launch.
extern "C" int cct_stage(const void* sum, const void* tilt, int canvas_w, const void* inv,
                         const void* alive_in, void* alive_out, void* passed0, int out_h,
                         int out_w, const void* rects, const void* wts, const void* tparam,
                         const void* tilted, const void* stage_start, const void* stage_thr,
                         int s0, int s1, void* stream) {
  const long long n = static_cast<long long>(out_h) * out_w;
  if (n <= 0 || s0 < 0 || s1 < s0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const Trees tr{static_cast<const int4*>(rects), static_cast<const float*>(wts),
                 static_cast<const float*>(tparam), static_cast<const int32_t*>(tilted),
                 static_cast<const int32_t*>(stage_start),
                 static_cast<const float*>(stage_thr)};
  stage_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sum), static_cast<const int32_t*>(tilt), canvas_w,
      static_cast<const float*>(inv), static_cast<const uint8_t*>(alive_in),
      static_cast<uint8_t*>(alive_out), static_cast<uint8_t*>(passed0), out_h, out_w, tr, s0,
      s1);
  return static_cast<int>(cudaGetLastError());
}
