// The Haar node-tree policy of the front and stage kernels: cascades whose
// trees have more than one internal node (haarcascade_frontalface_alt2,
// haarcascade_eye_tree_eyeglasses with tilted nodes, the 2-split eye
// cascades), every stage walked as node trees, stage sums in f32 or f64.
//
// Replaces, on the port's front and stage paths,
// cascadeclassifier_tpu/detect/dense.py::dense_stage_deep (XLA, is_haar)
// as the JAX package's fused and XLA engines run it: there every node is
// evaluated at every window and the paths are taken by masked selects;
// here each window walks its own path from the root (cascade_tile.cuh:
// NodeTrees<HaarNode>), the root of a tree taken by the J windows of a
// thread together, so a window evaluates only the nodes it visits.
// front.cu and stage.cu call these entries for kind cct::kNode; they sit in
// a translation unit of their own so that the instantiations build in
// parallel with the others.
//
// Bound: as the stump policy's (front.cu, stage.cu), with one more
// dependent record load and rect gather chain for every node below the
// root a window visits, and divergence where the windows of a warp take
// different paths. Times on the card: PERF.md.

#include "cascade_tile.cuh"

namespace cct {

int front_node(int exact, int pitch, const Frame& f, const Cascade& cas, int s0, int s1,
               cudaStream_t stream) {
  return dispatch_exact<CCT_FRONT_TILE_H, CCT_FRONT_THREADS, false, NodeTrees<HaarNode>>(
      exact, pitch, f, cas, s0, s1, stream);
}

int stage_node(int exact, int pitch, const Frame& f, const Cascade& cas, int s0, int s1,
               cudaStream_t stream) {
  return dispatch_exact<CCT_STAGE_TILE_H, CCT_STAGE_THREADS, true, NodeTrees<HaarNode>>(
      exact, pitch, f, cas, s0, s1, stream);
}

}  // namespace cct
