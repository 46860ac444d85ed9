"""Times the HOG kernels (``csrc/hog_hist.cu``, ``csrc/hog_eval.cu``) in
other geometries and with parts of their work taken out, to show what
their time depends on.

    python3 -m cascadeclassifier_tpu_torch.utils.tune_hog

Needs a CUDA device and nvcc. Builds each source as it is and once per
variant below (a text substitution in a copy of the source; all nvcc runs
started together, under ``_build/tune_hog/``), then times each on
``utils/time_hog.py``'s inputs and variables: 3 072 windows at 24x24 like
stage 0's, the same at 32x32, the detector's batch of 8 192 with a dozen
variables, and 1 024 windows whose histograms stay in L2. A variant or
plan that keeps the arithmetic gives the default's bits (printed as
``same``); one that takes work out gives other outputs, and only its time
is read. Each time is given twice: CUDA events over 20 launches in a row
(``ms``, which a short kernel's host launch cost can bound) and the
kernels' own device time from torch.profiler (``device``; for hog_eval
the plan's, the per-feature gather's and the direct gather's apart).

hog_hist:
  store4        the aligned body of a run in 4-byte stores, not by
                cp.async.bulk from one thread
  store16       the same in 16-byte stores
  regs32        registers capped at 32 (__launch_bounds__ for 2 CTAs of
                1 024 threads), not 64
  no_store      no step 4: nothing written to device memory
  no_scans      no steps 2-3: the pixels' values stored unscanned
  store_only    only step 4: shared memory as it is, stored
the default and store16 at other plans (``thr``, ``ch`` in the output):
64 to 512 threads a CTA, channel groups of 5 and of 2; the others at the
wrapper's plan (``ops/hog.py::hist_plan``).

hog_eval (the per-feature gather but for the direct_max variants):
  per_output      every asked cell's 4 corners read for it, as a thread
                  an output would (the norm still once a feature)
  warps2, 8       2 or 8 warps a CTA instead of 4
  tiles_fast      the tile of windows the grid's fast index, not the
                  feature (so a tile's features run apart in time)
  direct_max0     every list through the plan and the per-feature
                  gather, also the detector's dozen variables
  direct_max4096  a thread an output for lists up to 4 096 variables
  no_store        no step 3: nothing written to device memory
then the two gathers against each other, direct_max0 (the plan and the
per-feature gather) and direct_max4096 (a thread an output), on k
distinct variables drawn at random, k from 8 to all 324, on stage 0's
3 072 windows at 24x24 and on the detector's 8 192: where they cross is
``kDirectMax``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess

import numpy as np

import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.ops import hog
from cascadeclassifier_tpu_torch.ops.features import hog_catalog
from cascadeclassifier_tpu_torch.utils.time_hog import REPS, cuda_ms, device_ms, inputs, var_ids


def const(name: str, default: int, value: int):
    return [(f"constexpr int {name} = {default};", f"constexpr int {name} = {value};")]


HIST_VARIANTS = {
    "default": [],
    "store4": [("const int body = (len - head) / 4;", "const int body = 0;")],
    "store16": [("if (body > 0 && t == 0) {",
                 "for (int i = t; i < body; i += nt)\n"
                 "    reinterpret_cast<float4*>(dst + head)[i] =\n"
                 "        reinterpret_cast<const float4*>(src + head)[i];\n"
                 "  if (false) {")],
    "regs32": [("__launch_bounds__(kMaxThreads)", "__launch_bounds__(kMaxThreads, 2)")],
    "no_store": [("  if (nb) copy_planes(", "  if (false) copy_planes("),
                 ("  if (c1 == kChannels) copy_planes(", "  if (false) copy_planes(")],
    "no_scans": [("for (int i = t; i < nc * h; i += nt) {", "for (int i = t; i < 0; i += nt) {"),
                 ("for (int i = t; i < nc * w; i += nt) {", "for (int i = t; i < 0; i += nt) {")],
    "store_only": [("for (int i = t; i < hw; i += nt) {", "for (int i = t; i < 0; i += nt) {"),
                   ("for (int i = t; i < nc * h; i += nt) {",
                    "for (int i = t; i < 0; i += nt) {"),
                   ("for (int i = t; i < nc * w; i += nt) {",
                    "for (int i = t; i < 0; i += nt) {")],
}
EVAL_VARIANTS = {
    "default": [],
    "per_output": [("for (int c = 0; c < 4; ++c) need |= 1u << point(k, c);",
                    "for (int c = 0; c < 4; ++c) need |= 0u;"),
                   ("const float cs = corners(v[point(k, 0)], v[point(k, 1)], v[point(k, 2)], "
                    "v[point(k, 3)]);",
                    "const float cs = valid ? corners(__ldg(hb + o[4 * k]), "
                    "__ldg(hb + o[4 * k + 1]), __ldg(hb + o[4 * k + 2]), "
                    "__ldg(hb + o[4 * k + 3])) : 0.f;")],
    "warps2": const("kWarps", 4, 2),
    "warps8": const("kWarps", 4, 8),
    "tiles_fast": [("const int f = blockIdx.x,", "const int f = blockIdx.y,"),
                   ("for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y)",
                    "for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)"),
                   ("const dim3 grid(nf, tiles < kMaxGridY ? tiles : kMaxGridY);",
                    "const dim3 grid(tiles, nf);")],
    "direct_max0": const("kDirectMax", 64, 0),
    "direct_max4096": const("kDirectMax", 64, 4096),
    "no_store": [("      out[static_cast<size_t>(pos[j]) * n + i] = ",
                  "      if (n < 0) out[static_cast<size_t>(pos[j]) * n + i] = ")],
}


def build_all() -> dict:
    """{(source, variant): loaded library}, the nvcc runs in parallel."""
    out = os.path.join(_build.BUILD_DIR, "tune_hog")
    os.makedirs(out, exist_ok=True)
    jobs = {}
    for source, variants in (("hog_hist.cu", HIST_VARIANTS), ("hog_eval.cu", EVAL_VARIANTS)):
        with open(os.path.join(_build.CSRC_DIR, source)) as f:
            text = f.read()
        for name, subs in variants.items():
            src = text
            for old, new in subs:
                if old not in src:
                    raise RuntimeError(f"variant {name}: {old!r} is not in {source}")
                src = src.replace(old, new)
            stem = f"{source[:-3]}_{name}"
            cu = os.path.join(out, f"{stem}.cu")
            with open(cu, "w") as f:
                f.write(src)
            jobs[(source, name)] = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-shared", cu, "-o",
                                    os.path.join(out, f"{stem}.so")]
    procs = {key: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True) for key, cmd in jobs.items()}
    libs = {}
    for key, proc in procs.items():
        log = proc.communicate()[0]
        _build._raise_on_failure(jobs[key], proc.returncode, log)
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        print(f"{key[0]} {key[1]:12s} ptxas: {' | '.join(regs)}", flush=True)
        lib = ctypes.CDLL(jobs[key][-1])
        fn = "cct_hog_hist" if key[0] == "hog_hist.cu" else "cct_hog_eval"
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    return libs


def hist_plans(h: int, w: int):
    """(label, HistPlan): the wrapper's, then the others timed."""
    base = hog.hist_plan(h, w)
    plane = (h + 1) * base.stride
    yield "default", base
    for t in (64, 96, 128, 160, 192, 224, 256, 320, 512):
        yield f"thr{t}", dataclasses.replace(base, threads=t)
    for c in (5, 2):
        yield f"ch{c}", dataclasses.replace(base, channels=c, shared=hog.shared_bytes(c, plane))


def sweep_ids(k: int, var_count: int):
    """k distinct variables of var_count, drawn with a seed of k."""
    return np.sort(np.random.default_rng(k).choice(var_count, k, replace=False))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tune_hog needs a CUDA device")
    dev = torch.device("cuda")
    data = inputs(dev)
    libs = build_all()
    stream = torch.cuda.current_stream(dev).cuda_stream
    table = hog.bin_table(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; ms over {REPS} launches after one", flush=True)
    for (source, name), lib in libs.items():
        if source != "hog_hist.cu":
            continue
        for label, x in data.items():
            n, h, w = x.shape
            want = hog.hog_integral_histogram(x)
            hist, norm = torch.empty_like(want[0]), torch.empty_like(want[1])
            plans = (hist_plans(h, w) if name in ("default", "store16")
                     else [("default", hog.hist_plan(h, w))])
            for pname, plan in plans:
                def run(lib=lib, plan=plan, x=x, hist=hist, norm=norm):
                    _build.check(lib.cct_hog_hist(x.data_ptr(), table.data_ptr(), n, h, w,
                                                  plan.channels, plan.threads, hist.data_ptr(),
                                                  norm.data_ptr(), stream),
                                 "cct_hog_hist")
                hist.fill_(float("nan"))
                ms = cuda_ms(run)
                same = torch.equal(hist, want[0]) and torch.equal(norm, want[1])
                dev_ms = device_ms(run, ["hog_hist_kernel"])["hog_hist_kernel"]
                print(f"hog_hist {name:10s} {label:20s} {pname:8s} {plan.channels} ch "
                      f"{plan.threads} thr {plan.shared} B: {ms:.4f} ms, device {dev_ms:.4f} ms, "
                      f"same {same}", flush=True)
    for label, x in data.items():
        n, h, w = x.shape
        hist, norm = hog.hog_integral_histogram(x)
        flat = (hist.reshape(n, 9, -1), norm.reshape(n, -1))
        cat = hog_catalog(w, h)
        cells = torch.from_numpy(cat.cell_corner_offsets()).to(dev)
        ids = torch.from_numpy(var_ids(label, cat.var_count)).to(dev)
        for (source, name), lib in libs.items():
            if source == "hog_eval.cu":
                time_eval(lib, name, label, flat, cells, ids, stream)
        if label in ("24x24 3072", "24x24 8192 detector"):
            for k in (8, 16, 32, 48, 64, 96, 128, 192, 256, cat.var_count):
                ids = torch.from_numpy(sweep_ids(k, cat.var_count)).to(dev)
                for name in ("direct_max0", "direct_max4096"):
                    time_eval(libs[("hog_eval.cu", name)], name, label + " sweep", flat, cells,
                              ids, stream)


def time_eval(lib, name, label, flat, cells, ids, stream):
    """Times one build of hog_eval.cu on the variables ids; prints its
    event time, its kernels' device times and whether it gives the
    wrapper's bits."""
    n, p = flat[1].shape
    nf, k = cells.shape[0], ids.numel()
    want = hog.hog_responses(*flat, cells, ids)
    scratch = torch.empty(2 * nf + 1 + 2 * k, dtype=torch.int32, device=want.device)
    out = torch.full_like(want, float("nan"))

    def run():
        _build.check(lib.cct_hog_eval(flat[0].data_ptr(), flat[1].data_ptr(), cells.data_ptr(),
                                      ids.data_ptr(), n, p, nf, k, scratch.data_ptr(),
                                      out.data_ptr(), stream), "cct_hog_eval")
    ms = cuda_ms(run)
    same = torch.equal(out, want)
    d = device_ms(run, ["hog_eval_plan_kernel", "hog_eval_kernel", "hog_eval_direct_kernel"])
    print(f"hog_eval {name:14s} {label:26s} {k:4d} vars: {ms:.4f} ms, device: plan "
          f"{d['hog_eval_plan_kernel']:.4f} ms, gather {d['hog_eval_kernel']:.4f} ms, direct "
          f"{d['hog_eval_direct_kernel']:.4f} ms, total {sum(d.values()):.4f} ms, same {same}",
          flush=True)


if __name__ == "__main__":
    main()
