"""Build and bind the port's CUDA kernels.

The kernels in ``csrc/*.cu`` expose a plain ``extern "C"`` interface. At
first use each source is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library under
``cascadeclassifier_tpu_torch/_build/<hash>/``, keyed by a hash of the
sources and flags, and loaded with ``ctypes``. Nothing here includes
PyTorch's headers, so a build takes seconds rather than minutes.

Wrappers pass ``tensor.data_ptr()`` values and the current stream's
handle; every C entry point returns ``cudaGetLastError()`` after its
launches, and ``check()`` raises on a non-zero code. A failed build
raises with nvcc's output; nothing falls back to the plain versions.

``LAUNCHES`` counts kernel launches per wrapper: each wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("integral.cu", "front.cu", "patchify.cu", "tilted.cu", "stage.cu",
           "packed_front.cu")
HEADERS = ("cascade_tile.cuh",)  # included by front.cu and stage.cu
NVCC_FLAGS = (
    "-O3",
    "--fmad=false",
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-Xcompiler", "-fPIC",
)
LIB_NAME = "libcctorch_kernels.so"

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # px, sum, sq, chunk totals, h, w, chunk rows, stream
    "cct_integral": [_P, _P, _P, _P, _I, _I, _I, _P],
    # canvas, canvas_w, inv, alive_in, alive_out, out_h, out_w, win_h, win_w,
    # records, pitch, stage_start, stage_thr, s0, s1, stream
    "cct_front": [_P, _I, _P, _P, _P, _I, _I, _I, _I,
                  _P, _I, _P, _P, _I, _I, _P],
    # canvas, canvas_w, inv, alive_in, alive_out, out_h, out_w, blk,
    # nblk (device), nb_cap, rects, weights, tree params, stage_start,
    # stage_thr, s0, s1, stream
    "cct_packed_front": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _I,
                         _P, _P, _P, _P, _P, _I, _I, _P],
    # canvas, canvas_h, canvas_w, r, c, n, cnt, ph, pw, out, stream
    "cct_patchify": [_P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P],
    # px, out, h, w, segments, n segments, padded width, stream
    "cct_tilted": [_P, _P, _I, _I, _P, _I, _I, _P],
    # sum, tilt, has_tilt, canvas_w, inv, alive_in, alive_out, passed0, out_h,
    # out_w, win_h, win_w, records, pitch, tile_h, stage_start, stage_thr, s0,
    # s1, stream
    "cct_stage": [_P, _P, _I, _I, _P, _P, _P, _P, _I,
                  _I, _I, _I, _P, _I, _I, _P, _P, _I,
                  _I, _P],
}

_lib = None


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "CUDA kernels of cascadeclassifier_tpu_torch cannot be built"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels (or reuse a build of the same sources);
    returns the shared library's path."""
    out_dir = os.path.join(BUILD_DIR, _source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _find_nvcc()
    # build next to the target, then rename: a concurrent or interrupted
    # build never leaves a half-written library at lib_path
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, s.replace(".cu", ".o")) for s in SOURCES]
        jobs = [
            [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, s), "-o", o]
            for s, o in zip(SOURCES, objs)
        ]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in jobs]
        outputs = [proc.communicate()[0] for proc in procs]  # every job ends first
        for cmd, proc, output in zip(jobs, procs, outputs):
            _raise_on_failure(cmd, proc.returncode, output)
        so = os.path.join(tmp, LIB_NAME)
        cmd = [nvcc, "-shared", "-o", so, *objs]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _raise_on_failure(cmd, proc.returncode, proc.stdout)
        os.replace(so, lib_path)
    return lib_path


def _raise_on_failure(cmd, code: int, output: str):
    if code != 0:
        raise RuntimeError(f"nvcc failed (exit {code}):\n{' '.join(cmd)}\n{output}")


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def check_impl(impl: str):
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")


def use_ref(t, impl: str) -> bool:
    """Dispatch rule shared by every kernel wrapper: the plain PyTorch
    twin for a CPU tensor or an explicit impl="ref"; the CUDA kernel for
    a CUDA tensor; anything else raises."""
    check_impl(impl)
    if impl == "ref" or t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def require(t, dtype, ndim: int, name: str, device):
    """Validate a tensor handed to a kernel: device, dtype, rank,
    contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
