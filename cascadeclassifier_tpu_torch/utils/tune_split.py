"""Times the split kernel (``csrc/split_scan.cu``) with parts of its work
taken out, to show where its time goes.

    python3 -m cascadeclassifier_tpu_torch.utils.tune_split

Needs a CUDA device and nvcc. Builds the source as it is and once per
ablation below (each a text substitution in a copy of the source, under
``_build/tune_split/``), then times, on one synthetic block of 32 768
features x 3 072 samples (values of 1 000 levels, so with ties; 90 % of the
samples masked in), the gathered form on ``torch.sort``'s (B, N) outputs
and on a contiguous (N, B) block, and the array form. An ablation that
changes the arithmetic gives other outputs (printed as ``same False``);
only its time is read.

  global      the tables read from global memory (L2) instead of shared
  stages3     a ring of 3 stages instead of 2
  no_gather   no table gather: weights made from the sort order's bits
  no_quality  no quality: a sum in place of the 16 quality evaluations
  tile8       tiles of 8 features (CTAs of 128 threads, two an SM)
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.train.split import scan_levels

ABLATIONS = {
    "default": [],
    "global": [("shared <= static_cast<size_t>(optin)", "false")],
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "no_gather": [("const double2 t = tab[here ? j : n];",
                   "const double2 t = make_double2(double(j & 1023), 1.0);")],
    "no_quality": [("quality(a, (judged >> m) & 1u, v[m], nxa[m], lw[m], lr[m])",
                    "lw[m] + lr[m] + double(judged >> m)")],
    "tile8": [("constexpr int kTile = 16; ", "constexpr int kTile = 8; ")],
}
N_SAMPLES, N_FEATURES, REPS = 3072, 32768, 20


def build(name: str, subs) -> ctypes.CDLL:
    with open(os.path.join(_build.CSRC_DIR, "split_scan.cu")) as f:
        src = f.read()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"ablation {name}: {old!r} is not in split_scan.cu")
        src = src.replace(old, new)
    out = os.path.join(_build.BUILD_DIR, "tune_split")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, f"{name}.cu"), os.path.join(out, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-shared", cu, "-o", so]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build._raise_on_failure(cmd, proc.returncode, proc.stdout)
    lib = ctypes.CDLL(so)
    for fn in ("cct_split_scan", "cct_split_scan_gather"):
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def cuda_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(REPS):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / REPS


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tune_split needs a CUDA device")
    dev = torch.device("cuda")
    n, b = N_SAMPLES, N_FEATURES
    gen = torch.Generator(device=dev).manual_seed(0)
    vals = torch.randint(0, 1000, (b, n), device=dev, generator=gen).float() * 0.37
    vs_bn, si_bn = torch.sort(vals, dim=1, stable=True)
    w = torch.rand(n, device=dev, dtype=torch.float64, generator=gen) ** 3
    w /= w.sum()
    mask = torch.rand(n, device=dev, generator=gen) > 0.1
    wm = torch.where(mask, w, 0.0)
    rm = wm * torch.where(torch.rand(n, device=dev, generator=gen) > 0.5, 1.0, -1.0).double()
    tw, tr = float(wm.sum()), float(rm.sum())
    layouts = {"fresh (B, N)": (vs_bn.t(), si_bn.t()),
               "resident (N, B)": (vs_bn.t().contiguous(), si_bn.t().contiguous())}
    vs_c, si_c = layouts["resident (N, B)"]
    arrays = (vs_c, wm[si_c], rm[si_c], mask[si_c])
    stream = torch.cuda.current_stream(dev).cuda_stream
    q = torch.empty(b, dtype=torch.float64, device=dev)
    thr = torch.empty(b, dtype=torch.float32, device=dev)
    levels = scan_levels(n)
    print(f"{torch.cuda.get_device_name(0)}; {b} features x {n} samples; ms over {REPS} "
          f"launches after one")
    want = {}
    for name, subs in ABLATIONS.items():
        lib = build(name, subs)
        runs = {lay: (lambda vs=vs, o=o: lib.cct_split_scan_gather(
            vs.data_ptr(), vs.stride(0), vs.stride(1), o.data_ptr(), o.stride(0), o.stride(1),
            wm.data_ptr(), rm.data_ptr(), mask.data_ptr(), n, b, levels, tw, tr, q.data_ptr(),
            thr.data_ptr(), stream)) for lay, (vs, o) in layouts.items()}
        runs["array form"] = lambda: lib.cct_split_scan(
            *(t.data_ptr() for t in arrays), n, b, levels, tw, tr, q.data_ptr(), thr.data_ptr(),
            stream)
        for lay, run in runs.items():
            code = run()
            if code != 0:  # e.g. a ring that no longer fits in shared memory
                print(f"{name:11s} {lay:16s} refused (CUDA error {code})", flush=True)
                continue
            ms = cuda_ms(run)
            got = (q.clone(), thr.clone())
            want.setdefault(lay, got)
            same = all(torch.equal(x, y) for x, y in zip(got, want[lay]))
            print(f"{name:11s} {lay:16s} {ms:.4f} ms  same {same}", flush=True)


if __name__ == "__main__":
    main()
