"""Times the two-class split kernel (``csrc/split_class.cu``) with parts of
its design changed or taken out, beside the design it replaces (the
two-class policy of ``csrc/split_scan.cu``) rebuilt, to show where its
time goes:

    python3 -m cascadeclassifier_tpu_torch.utils.tune_split_class

Needs a CUDA device and nvcc. Builds the source as it is and once per
variant below (each a text substitution in a copy of the source, under
``_build/tune_split_class/``, all nvcc runs started together), then times
both policies on ``utils/tune_split.py``'s block of 32 768 features x 3 072
samples (classes half and half) on ``torch.sort``'s (B, N) outputs, the
default also on a contiguous (N, B) block, and prints each variant's ptxas
registers and spills and its resident CTAs an SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). A variant that changes
the arithmetic gives other outputs (``same False``); only its time is read.

  global        the table read from global memory (L2) instead of shared
  stages2       two stages a warp (the next chunk's copies in flight), one
                CTA an SM
  warps8        8 warps a CTA (16 an SM)
  warps16       16 warps a CTA, one CTA an SM (one table an SM)
  element_copy  every sample copied alone, as for a strided layout
  no_gather     no table gather: entries made from the sort order's bits
  no_bound      Gini divides at every valid position
  no_walk       no second pass (the walk and every quality)
  copies_only   neither pass: the copies, the exchange and the merge
  no_quality    no quality: c0 + c1 in its place
  scan_policy   the replaced design: split_scan.cu with its two-class quality
                put back

``scan_policy_kernels()`` builds the last for ``chip_smoke.py``, which
times it beside the kernel in the same run.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.train.split import scan_levels, tree_sum

VARIANTS = {
    "default": [],
    "global": [("if (table_in_shared(n))", "if (false)")],
    "stages2": [("constexpr int kStages = 1;", "constexpr int kStages = 2;"),
                ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")],
    "warps8": [("constexpr int kWarps = 12; ", "constexpr int kWarps = 8; ")],
    "warps16": [("constexpr int kWarps = 12; ", "constexpr int kWarps = 16; "),
                ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")],
    "element_copy": [("a.bulk = vs_si == 1", "a.bulk = false && vs_si == 1")],
    "no_gather": [("e[h] = here ? tab[j] : CUDART_NAN;",
                   "e[h] = here ? double(j & 1023) * ((j & 1024) ? -1.0 : 1.0) : CUDART_NAN;")],
    "no_bound": [("ok && tl > 0.0 && tr > 0.0 && !(num < __dmul_rn(b.lim, den))",
                  "ok && tl > 0.0 && tr > 0.0")],
    "no_walk": [("for (int q = 0; q < kBase / 4; ++q) {\n      const float4 vv",
                 "for (int q = 0; q < (a.n < 0 ? kBase / 4 : 0); ++q) {\n      const float4 vv")],
    "copies_only": [("for (int q = 0; q < kBase / 4; ++q) {\n      const float4 vv",
                     "for (int q = 0; q < (a.n < 0 ? kBase / 4 : 0); ++q) {\n"
                     "      const float4 vv"),
                    ("for (int q = 0; q < kBase / 2; ++q) {\n      double2* p",
                     "for (int q = 0; q < (a.n < 0 ? kBase / 2 : 0); ++q) {\n      double2* p")],
    "no_quality": [("  const double r0 = __dsub_rn(a.t0, c0), r1 = __dsub_rn(a.t1, c1);\n",
                    "  if (ok) take(b, __dadd_rn(c0, c1), pos, v, nx);\n  return;\n"
                    "  const double r0 = __dsub_rn(a.t0, c0), r1 = __dsub_rn(a.t1, c1);\n")],
}
# split_scan.cu's two-class quality, as it stood in its quality<Q>() (Q =
# SCAN_POLICY: 1 misclassification, 2 Gini; the tables w0, w1)
SCAN_POLICY_QUALITY = """                                          double lw, double lr) {
  if (SCAN_POLICY != 0) {
    const double r0 = __dsub_rn(a.total_w, lw), r1 = __dsub_rn(a.total_r, lr);
    const bool apart = judged && __fadd_rn(v, kTwoFltEps) < nx && isfinite(nx);
    if (SCAN_POLICY == 1) return apart ? fmax(__dadd_rn(lw, r1), __dadd_rn(lr, r0)) : -CUDART_INF;
    const bool l1_first = a.n > kChunk && a.n % kBase != 0;
    const double tl = __dadd_rn(lw, lr), tr = __dadd_rn(r0, r1);
    const bool ok = apart && tl > 0.0 && tr > 0.0;
    const double left = l1_first ? __fma_rn(lr, lr, __dmul_rn(lw, lw))
                                 : __fma_rn(lw, lw, __dmul_rn(lr, lr));
    const double num = __fma_rn(left, tr, __dmul_rn(__fma_rn(r0, r0, __dmul_rn(r1, r1)), tl));
    const double q = __ddiv_rn(ok ? num : 0.0, ok ? __dmul_rn(tl, tr) : 1.0);
    return ok ? q : -CUDART_INF;
  }
"""
N_SAMPLES, N_FEATURES, REPS = 3072, 32768, 20
OUT = os.path.join(_build.BUILD_DIR, "tune_split_class")


def _start(name: str, source: str, subs, prefix: str = ""):
    """Write the variant's source and start its nvcc → (process, .so path)."""
    with open(os.path.join(_build.CSRC_DIR, source)) as f:
        src = f.read()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} is not in {source}")
        src = src.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
    with open(cu, "w") as f:
        f.write(prefix + src)
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-shared", cu, "-o", so]
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True), so


def _finish(started, entry: str):
    """Wait for the builds → {name: (library, ptxas resources)}."""
    out = {}
    for name, (cmd, proc, so) in started.items():
        log = proc.communicate()[0]
        _build._raise_on_failure(cmd, proc.returncode, log)
        lib = ctypes.CDLL(so)
        for fn in (entry, "cct_split_class_info"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
        out[name] = lib, _build.ptxas_resources(log)
    return out


def scan_policy_kernels() -> dict:
    """split_scan.cu's two-class policy rebuilt: {use_gini: (library, ptxas
    resources)}; each takes cct_split_scan_gather's arguments with the
    class tables and totals in place of the regression ones."""
    started = {gini: _start(f"scan_policy_{'gini' if gini else 'misclass'}", "split_scan.cu",
                            [(SCAN_POLICY_QUALITY.split("\n", 1)[0] + "\n",
                              SCAN_POLICY_QUALITY)],
                            f"#define SCAN_POLICY {2 if gini else 1}\n")
               for gini in (False, True)}
    return _finish(started, "cct_split_scan_gather")


def run_scan_policy(lib, vs, order, w0, w1, mask, t0, t1):
    """split_scan.cu's two-class policy on the two-class split's arguments → (q, thr)."""
    n, b = vs.shape
    q = torch.empty(b, dtype=torch.float64, device=vs.device)
    thr = torch.empty(b, dtype=torch.float32, device=vs.device)
    _build.check(lib.cct_split_scan_gather(
        vs.data_ptr(), vs.stride(0), vs.stride(1), order.data_ptr(), order.stride(0),
        order.stride(1), w0.data_ptr(), w1.data_ptr(), mask.data_ptr(), n, b, scan_levels(n),
        float(t0), float(t1), q.data_ptr(), thr.data_ptr(), _build.stream_of(vs)),
        "cct_split_scan_gather (two-class policy)")
    return q, thr


def run_class(lib, vs, order, w0, w1, mask, t0, t1, gini: bool):
    """A build of split_class.cu on the wrapper's arguments → (q, thr)."""
    n, b = vs.shape
    q = torch.empty(b, dtype=torch.float64, device=vs.device)
    thr = torch.empty(b, dtype=torch.float32, device=vs.device)
    _build.check(lib.cct_split_class(
        vs.data_ptr(), vs.stride(0), vs.stride(1), order.data_ptr(), order.stride(0),
        order.stride(1), w0.data_ptr(), w1.data_ptr(), mask.data_ptr(), n, b, scan_levels(n),
        int(gini), float(t0), float(t1), q.data_ptr(), thr.data_ptr(), _build.stream_of(vs)),
        "cct_split_class")
    return q, thr


def ctas_per_sm(lib, n: int, gini: bool) -> int:
    """The CTAs an SM holds for n samples (a build's cct_split_class_info)."""
    per_sm, shared = ctypes.c_int(), ctypes.c_int()
    _build.check(lib.cct_split_class_info(n, int(gini), ctypes.byref(per_sm),
                                          ctypes.byref(shared)), "cct_split_class_info")
    return per_sm.value


def block(dev, n: int = N_SAMPLES, b: int = N_FEATURES):
    """utils/tune_split.py's synthetic block with classes: (vs, order) as
    torch.sort's (B, N) outputs seen transposed, w0, w1, mask, t0, t1."""
    gen = torch.Generator(device=dev).manual_seed(0)
    vals = torch.randint(0, 1000, (b, n), device=dev, generator=gen).float() * 0.37
    vs_bn, si_bn = torch.sort(vals, dim=1, stable=True)
    w = torch.rand(n, device=dev, dtype=torch.float64, generator=gen) ** 3
    w /= w.sum()
    mask = torch.rand(n, device=dev, generator=gen) > 0.1
    cls = torch.rand(n, device=dev, generator=gen) > 0.5
    wm = torch.where(mask, w, 0.0)
    w0, w1 = torch.where(cls, 0.0, wm), torch.where(cls, wm, 0.0)
    t0 = tree_sum(w0.cpu().numpy())
    return vs_bn.t(), si_bn.t(), w0, w1, mask, t0, tree_sum(wm.cpu().numpy()) - t0


def main():
    from cascadeclassifier_tpu_torch.utils.time_hog import cuda_ms

    if not torch.cuda.is_available():
        raise SystemExit("tune_split_class needs a CUDA device")
    dev = torch.device("cuda")
    args = block(dev)
    resident = (args[0].contiguous(), args[1].contiguous(), *args[2:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; {N_FEATURES} features x {N_SAMPLES} samples; ms over {REPS} launches "
          "after one", flush=True)
    started = {name: _start(name, "split_class.cu", subs) for name, subs in VARIANTS.items()}
    libs = _finish(started, "cct_split_class")
    want = {}
    for name, (lib, res) in libs.items():
        regs = "; ".join(f"{r[1]} registers, {r[2]}/{r[3]} B spilled" for r in res)
        for gini in (False, True):
            layouts = {"fresh (B, N)": args}
            if name == "default":
                layouts["resident (N, B)"] = resident
            for lay, a in layouts.items():
                run = lambda a=a: run_class(lib, *a, gini)  # noqa: E731
                got = run()
                want.setdefault(gini, got)
                same = all(torch.equal(x, y) for x, y in zip(got, want[gini]))
                print(f"{name:12s} {'Gini' if gini else 'misclass':8s} {lay:16s} "
                      f"{cuda_ms(run):.4f} ms  same {same}  CTAs/SM "
                      f"{ctas_per_sm(lib, N_SAMPLES, gini)}  ptxas: {regs}", flush=True)
    for gini, (lib, res) in scan_policy_kernels().items():
        run = lambda lib=lib: run_scan_policy(lib, *args)  # noqa: E731
        same = all(torch.equal(x, y) for x, y in zip(run(), want[gini]))
        regs = "; ".join(f"{r[1]} registers, {r[2]}/{r[3]} B spilled" for r in res)
        print(f"{'scan_policy':12s} {'Gini' if gini else 'misclass':8s} {'fresh (B, N)':16s} "
              f"{cuda_ms(run):.4f} ms  same {same}  ptxas: {regs}", flush=True)


if __name__ == "__main__":
    main()
