"""cascadeclassifier_tpu_torch — the PyTorch / CUDA port of cascadeclassifier_tpu.

Multi-scale Viola–Jones detection from OpenCV cascade XML (Haar stumps
or node trees, upright or tilted, and LBP; f64 or f32 stage sums) on one
NVIDIA H100: plain PyTorch around hand-written CUDA kernels (canvas
integral, tilted integral, the tiled cascade kernel behind the front,
packed front and stage entry points, survivor patch gather). The JAX
package ``cascadeclassifier_tpu`` is the reference this package is held
against.

Importing the package has no side effects: kernels are compiled on first
use (``_build.py``).
"""

__version__ = "0.1.0"
