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

The host library, ``csrc/cctpu_io.cpp`` (grouping, the ``.vec`` codec and
the negative-window miner; C++17 and its standard library alone, no
OpenCV), is built the same way by ``build_host``: one ``g++`` at first use,
into ``_build/<hash>/``. It needs no CUDA and builds on any machine with
``g++``; a failed build raises with g++'s output, and nothing falls back.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("integral.cu", "front.cu", "patchify.cu", "tilted.cu", "stage.cu",
           "packed_front.cu", "tile_node.cu", "tile_lbp.cu", "split_scan.cu", "split_class.cu",
           "cat_split.cu", "hog_hist.cu", "hog_eval.cu", "mine.cu", "prep.cu")
# included by front.cu, stage.cu, packed_front.cu, tile_node.cu, tile_lbp.cu and prep.cu
HEADERS = ("cascade_tile.cuh",)
NVCC_FLAGS = (
    "-O3",
    "--fmad=false",
    "-Xptxas", "-v",  # registers and spills a kernel, kept in <source>.log
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-Xcompiler", "-fPIC",
)
LIB_NAME = "libcctorch_kernels.so"
HOST_SOURCE = "cctpu_io.cpp"
# -ffp-contract=off: the miner's float schedule rounds each product, as
# numpy's float32 scalars do
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off", "-Wall")
HOST_LIB_NAME = "libcctorch_io.so"

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong
_SIGNATURES = {
    # px, px element bytes, sum, sq, band sums and carry, h, w, band rows,
    # stream
    "cct_integral": [_P, _I, _P, _P, _P, _I, _I, _I, _P],
    # canvas, canvas_w, inv, alive_in, alive_out, out_h, out_w, win_h, win_w,
    # kind, exact, records, pitch, tree_root, leaves, stage_start, stage_thr,
    # s0, s1, stream
    "cct_front": [_P, _I, _P, _P, _P, _I, _I, _I, _I,
                  _I, _I, _P, _I, _P, _P, _P, _P,
                  _I, _I, _P],
    # canvas, canvas_w, inv, alive_in, alive_out, out_h, out_w, win_h, win_w,
    # blk, nblk (device), nb_cap, exact, records, pitch, stage_start,
    # stage_thr, s0, s1, stream
    "cct_packed_front": [_P, _I, _P, _P, _P, _I, _I, _I, _I,
                         _P, _P, _I, _I, _P, _I, _P,
                         _P, _I, _I, _P],
    # canvas, canvas_h, canvas_w, r, c, n, cnt, ph, pw, out, stream
    "cct_patchify": [_P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P],
    # px, out, h, w, segments, n segments, items, launch offsets (host),
    # n launches, state, state row length, stream
    "cct_tilted": [_P, _P, _I, _I, _P, _I, _P, _P, _I, _P, _I, _P],
    # sum, tilt, has_tilt, canvas_w, inv, alive_in, alive_out, passed0, out_h,
    # out_w, win_h, win_w, kind, exact, records, pitch, tile_h, tree_root,
    # leaves, stage_start, stage_thr, s0, s1, stream
    "cct_stage": [_P, _P, _I, _I, _P, _P, _P, _P, _I,
                  _I, _I, _I, _I, _I, _P, _I, _I, _P,
                  _P, _P, _P, _I, _I, _P],
    # sum, sq, canvas_w, code, inv_out, alive_out, out_h, out_w, win_h, win_w,
    # kind, exact, records, pitch, tree_root, leaves, stage_start, stage_thr,
    # stream
    "cct_prep": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                 _I, _I, _P, _I, _P, _P, _P, _P,
                 _P],
    # vs, ws, rs, kept, n, b, levels, total_w, total_r, q, thr, stream
    "cct_split_scan": [_P, _P, _P, _P, _I, _I, _I, _D, _D, _P, _P, _P],
    # vs, its strides (samples, features), order, its strides, the two
    # tables, mask, n, b, levels, the tables' totals, q, thr, stream
    "cct_split_scan_gather": [_P, _L, _L, _P, _L, _L, _P, _P, _P,
                              _I, _I, _I, _D, _D, _P, _P, _P],
    # vs, its strides, order, its strides, w0, w1, mask, n, b, levels, gini,
    # t0, t1, q, thr, stream
    "cct_split_class": [_P, _L, _L, _P, _L, _L, _P, _P, _P,
                        _I, _I, _I, _I, _D, _D, _P, _P, _P],
    # n, gini, CTAs an SM (out), table in shared memory (out)
    "cct_split_class_info": [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    # the largest n whose table goes to shared memory (out)
    "cct_split_class_shared_max": [ctypes.POINTER(_I)],
    # codes, the two tables, n, b, policy, q, subset, stream
    "cct_cat_split": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    # n, the features one launch works on at once (out)
    "cct_cat_split_slots": [_I, ctypes.POINTER(_I)],
    # img, bin table, n, h, w, channels a group, threads, hist, norm, stream
    "cct_hog_hist": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # hist, norm, cells, var ids, n, p, features, k, the plan's scratch,
    # out, stream
    "cct_hog_eval": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # level table, rows, tiles, tile shape (tx, ty), hand-off count, lazy
    # arena, eager arena, ww, wh, kind, corner offsets, weights, tilted
    # flags, LBP points, tree features, thresholds, left and right leaves,
    # subsets, trees, stage ends, stage thresholds, stages, out, windows,
    # stream
    "cct_mine": [_P, _I, _L, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                 _P, _P, _I, _P, _P, _I, _P, _L, _P],
    # ww, wh, kind, tx, ty, shared bytes a CTA (out), CTAs an SM (out)
    "cct_mine_info": [_I, _I, _I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    # cct_mine's arguments without the tiles, the shape and the hand-off
    # count (the warp-a-window design)
    "cct_mine_warp": [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _P, _P, _I, _P, _L, _P],
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


def _find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the host library of "
                           "cascadeclassifier_tpu_torch cannot be built")
    return gxx


def _source_hash(flags, names) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in names:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels (or reuse a build of the same sources);
    returns the shared library's path."""
    # the flags and sources as they are now: a tuning run swaps NVCC_FLAGS
    out_dir = os.path.join(BUILD_DIR, _source_hash(NVCC_FLAGS, SOURCES + HEADERS))
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
        for s, output in zip(SOURCES, outputs):
            with open(os.path.join(out_dir, s + ".log"), "w") as f:
                f.write(output)
        so = os.path.join(tmp, LIB_NAME)
        cmd = [nvcc, "-shared", "-o", so, *objs]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _raise_on_failure(cmd, proc.returncode, proc.stdout)
        os.replace(so, lib_path)
    return lib_path


def build_host() -> str:
    """Compile the host library with g++ (or reuse a build of the same
    source and flags); returns the shared library's path."""
    out_dir = os.path.join(BUILD_DIR, _source_hash(GXX_FLAGS, (HOST_SOURCE,)))
    lib_path = os.path.join(out_dir, HOST_LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        so = os.path.join(tmp, HOST_LIB_NAME)
        cmd = [_find_gxx(), *GXX_FLAGS, os.path.join(CSRC_DIR, HOST_SOURCE), "-o", so]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _raise_on_failure(cmd, proc.returncode, proc.stdout)
        os.replace(so, lib_path)
    return lib_path


def kernel_resources(source: str) -> list:
    """ptxas's report for each kernel of a built source: (entry point,
    registers, spill store bytes, spill load bytes)."""
    with open(os.path.join(os.path.dirname(build()), source + ".log")) as f:
        return ptxas_resources(f.read())


def ptxas_resources(log: str) -> list:
    """(entry point, registers, spill store bytes, spill load bytes) for
    each kernel in the output of ``nvcc -Xptxas -v``."""
    out = []
    for part in re.split(r"Compiling entry function '", log)[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        out.append((name, int(regs.group(1)) if regs else None,
                    *(map(int, spill.groups()) if spill else (None, None))))
    return out


def _raise_on_failure(cmd, code: int, output: str):
    if code != 0:
        tool = os.path.basename(cmd[0])
        raise RuntimeError(f"{tool} failed (exit {code}):\n{' '.join(cmd)}\n{output}")


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


def require(t, dtype, ndim: int, name: str, device, contiguous: bool = True):
    """Validate a tensor handed to a kernel: device, dtype (one, or a
    tuple of those the kernel takes), rank, contiguity (unless the kernel
    takes the strides)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
