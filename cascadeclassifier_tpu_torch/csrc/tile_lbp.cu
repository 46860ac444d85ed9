// The LBP policy of the front and stage kernels: local-binary-pattern
// cascades (lbpcascade_*), categorical stumps or node trees, stage sums in
// f32 or f64; no variance gate and no inv_nf.
//
// Replaces, on the port's front and stage paths,
// cascadeclassifier_tpu/detect/dense.py::dense_stage_lbp and, for LBP node
// trees, dense_stage_deep (XLA), with _dense_lbp_code and
// ops/features.py::lbp_code_grid: a node reads the 16 corners of its 4 x 4
// grid of cells from the shared patch, forms the 9 cell sums and the code,
// and takes the left child iff the code's bit of its subset is set
// (cascade_tile.cuh: NodeTrees<LbpNode>; a stump is a tree of one node).
// The JAX fused engine's matmul tail for LBP (compact.py::
// make_lbp_tail_compact_fn, XLA) has no counterpart: the tile kernel runs
// every LBP stage. front.cu and stage.cu call these entries for kind
// cct::kLbp; they sit in a translation unit of their own so that the
// instantiations build in parallel with the others.
//
// Bound: about 16 shared-memory gathers and 9 integer differences a node
// and window, the subset word one load from the read-only path, the leaf
// one more; the lists after stage 0 are bound by latency as the Haar
// policies' are. Times on the card: PERF.md.

#include "cascade_tile.cuh"

namespace cct {

int front_lbp(int exact, int pitch, const Frame& f, const Cascade& cas, int s0, int s1,
              cudaStream_t stream) {
  return dispatch_exact<CCT_FRONT_TILE_H, CCT_FRONT_THREADS, false, NodeTrees<LbpNode>>(
      exact, pitch, f, cas, s0, s1, stream);
}

int stage_lbp(int exact, int pitch, const Frame& f, const Cascade& cas, int s0, int s1,
              cudaStream_t stream) {
  return dispatch_exact<CCT_STAGE_TILE_H, CCT_STAGE_THREADS, true, NodeTrees<LbpNode>>(
      exact, pitch, f, cas, s0, s1, stream);
}

}  // namespace cct
