"""cascadeclassifier_tpu_torch — the PyTorch / CUDA port of cascadeclassifier_tpu.

Multi-scale Viola–Jones detection from OpenCV cascade XML on one NVIDIA
H100: plain PyTorch around three hand-written CUDA kernels (canvas
integral, cascade front, survivor patch gather). The JAX package
``cascadeclassifier_tpu`` is the reference this package is held against.

Importing the package has no side effects: kernels are compiled on first
use (``_build.py``).
"""

__version__ = "0.1.0"
