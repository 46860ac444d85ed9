"""The check that nothing the benchmark loads is JAX or the JAX package.

A module's top-level name (the part before the first dot) is compared
whole, so ``cascadeclassifier_tpu_torch``, the program, passes while
``cascadeclassifier_tpu`` and ``jax`` do not.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "cascadeclassifier_tpu")


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
