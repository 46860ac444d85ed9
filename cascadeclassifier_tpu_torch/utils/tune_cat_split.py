"""Times the categorical split kernel (``csrc/cat_split.cu``) in other
geometries and with parts of its work taken out, to show what its time
depends on.

    python3 -m cascadeclassifier_tpu_torch.utils.tune_cat_split

Needs a CUDA device and nvcc. Builds the source once per variant below (a
text substitution in a copy of the source; all nvcc runs started
together, under ``_build/tune_cat_split/``), then times the regression
policy on blocks of 8 464 features x 3 072 samples (stage 0's LBP block at
24x24) of four code distributions: the LBP codes of synthetic 24x24
windows (``lbp_block``), skewed codes like them (``utils/edges.py::
skewed_codes``), uniform random codes and one code a feature, with each
one's distinct codes and largest group a window. A variant that keeps the
arithmetic gives the default's bits (printed as ``same``); one that takes
work out gives other outputs, and only its time is read.

  warps4, warps16   4 or 16 warps a CTA instead of 8
  depth1, 3, 4      1, 3 or 4 windows of 32 samples at a time (their group
                    sums interleaved, their loads issued together) instead of 2
  sm_warps16, 32    registers capped for 16 or 32 warps an SM instead of 24
                    (__launch_bounds__)
  depth4_warps16    4 windows at a time, registers for 16 warps an SM
  shared            the per-sample tables staged in shared memory (one
                    copy a CTA) instead of read from global memory
  shared_warps16    both shared and warps16
  ballot_groups     the groups from 9 ballots (validity and the code's 8
                    bits) instead of __match_any_sync (same bits)
  table_reads       a group's members read from the tables (L1/L2) by
                    sample index instead of shuffled (same bits)
  no_match          every lane a group of its own: no __match_any_sync
  one_step          one step of the group loop, whatever the group's size
  no_leader         no leader's add into the level-1 accumulator
  no_window_sync    no __syncwarp after each window's adds
  phase1_only       phase 1 alone: no sort, scans, quality or subset
  phase2_only       phase 2 alone: no window of samples walked
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np
import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.utils.edges import skewed_codes

MATCH = "const unsigned m = __match_any_sync(kFull, cd[d]);"


def const(name: str, default: int, value: int):
    return [(f"constexpr int {name} = {default};", f"constexpr int {name} = {value};")]


# the tables staged in shared memory by each CTA (n doubles twice, the
# kernel's one CTA barrier) and read from there
SHARED = [
    ("  double* base = reinterpret_cast<double*>(smem);\n",
     "  double* base = reinterpret_cast<double*>(smem);\n"
     "  for (int j = threadIdx.x; j < n; j += blockDim.x) {\n"
     "    base[j] = __ldg(a.t0 + j);\n"
     "    base[n + j] = __ldg(a.t1 + j);\n"
     "  }\n"
     "  __syncthreads();\n"
     "  t0 = base;\n"
     "  t1 = base + n;\n"
     "  base += 2 * n;\n"),
    ("x0[d] = in ? __ldg(t0 + i) : 0.0;", "x0[d] = in ? t0[i] : 0.0;"),
    ("x1[d] = in ? __ldg(t1 + i) : 0.0;", "x1[d] = in ? t1[i] : 0.0;"),
    ("cudaError_t plan(int nacc, Plan& p) {",
     "int g_n = 0;\ncudaError_t plan(int nacc, Plan& p) {"),
    ("p.smem = sizeof(double) * kWarps * static_cast<size_t>(warp_doubles(nacc));",
     "p.smem = sizeof(double) * (kWarps * static_cast<size_t>(warp_doubles(nacc)) + 2 * g_n);"),
    ("  if (!make_tree(n, a.tree))", "  g_n = n;\n  if (!make_tree(n, a.tree))"),
    ("  if (n <= 0 || !make_tree(n, t))", "  g_n = n;\n  if (n <= 0 || !make_tree(n, t))"),
]
VARIANTS = {
    "default": [],
    "warps4": const("kWarps", 8, 4),
    "warps16": const("kWarps", 8, 16),
    "depth1": const("kDepth", 2, 1),
    "depth3": const("kDepth", 2, 3),
    "depth4": const("kDepth", 2, 4),
    "sm_warps16": const("kSmWarps", 24, 16),
    "sm_warps32": const("kSmWarps", 24, 32),
    "depth4_warps16": const("kDepth", 2, 4) + const("kSmWarps", 24, 16),
    "shared": SHARED,
    "shared_warps16": SHARED + const("kWarps", 8, 16),
    "ballot_groups": [(MATCH, """\
unsigned m = __ballot_sync(kFull, valid);
#pragma unroll
        for (int bit = 0; bit < 8; ++bit) {
          const bool set = (cd[d] >> bit) & 1;
          m &= __ballot_sync(kFull, set) ^ (set ? 0u : kFull);
        }""")],
    "table_reads": [("""\
          const double v0 = __shfl_sync(kFull, x0[d], src);
          const double v1 = __shfl_sync(kFull, x1[d], src);
          if (rest[d]) {""", """\
          const int i = (w0 + d) * kWindow - lo0 + (src & 31);
          if (rest[d]) {
            const double v0 = __ldg(t0 + i), v1 = __ldg(t1 + i);""")],
    "no_match": [(MATCH, "const unsigned m = 1u << lane;")],
    "one_step": [("for (unsigned k = 0; k < g; ++k) {", "for (unsigned k = 0; k < 1u; ++k) {")],
    "no_leader": [("if (lead[d]) {", "if (g == 99u) {")],
    "no_window_sync": [("__syncwarp();  // the leaders' adds are seen by the next window's", "")],
    "phase1_only": [("// ---- phase 2: sort, scans, quality, subset",
                     "if (lane == 0) a.q_out[f] = h[0].x;\n    continue;")],
    "phase2_only": [("for (int w0 = 0; w0 < nw; w0 += kDepth) {",
                     "for (int w0 = 0; w0 < 0; w0 += kDepth) {")],
}
N_SAMPLES, N_FEATURES, REPS = 3072, 8464, 20


def build_all() -> dict:
    """{variant: loaded library}, the nvcc runs in parallel."""
    out = os.path.join(_build.BUILD_DIR, "tune_cat_split")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "cat_split.cu")) as f:
        text = f.read()
    jobs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} is not in cat_split.cu")
            src = src.replace(old, new)
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        jobs[name] = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-shared", cu, "-o",
                      os.path.join(out, f"{name}.so")]
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True) for name, cmd in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        _build._raise_on_failure(jobs[name], proc.returncode, log)
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        print(f"{name:15s} ptxas: {' | '.join(regs)}", flush=True)
        lib = ctypes.CDLL(jobs[name][-1])
        for fn in ("cct_cat_split", "cct_cat_split_slots"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def lbp_block(dev, n: int, b: int):
    """LBP codes (b, n) of 24x24 windows like stage 0's: 1 000 synthetic
    marks (utils/train_data.py) and random crops of a synthetic clutter
    frame, through the port's LBP evaluator (all 8 464 features)."""
    from cascadeclassifier_tpu_torch.ops.features import lbp_catalog
    from cascadeclassifier_tpu_torch.train.evaluators import LBPTrainEvaluator
    from cascadeclassifier_tpu_torch.utils import train_data

    rng = np.random.default_rng(1)
    bg = train_data.background(1080, 1920, seed=100)
    ys, xs = rng.integers(0, 1080 - 24, n - 1000), rng.integers(0, 1920 - 24, n - 1000)
    samples = np.concatenate([train_data.positives(1000, 24, seed=7),
                              np.stack([bg[y:y + 24, x:x + 24] for y, x in zip(ys, xs)])])
    ev = LBPTrainEvaluator(lbp_catalog(24, 24), device=dev)
    ev.set_samples(samples)
    return ev.values_block(0)[:b].contiguous()


def window_stats(codes) -> str:
    """Distinct codes and the largest group of a window of 32 samples, on
    average over the first 512 features."""
    c = codes[:512, :codes.shape[1] // 32 * 32].long()
    c = c.view(c.shape[0], -1, 32)
    counts = torch.zeros(*c.shape[:2], 256, device=c.device).scatter_add_(
        2, c, torch.ones_like(c, dtype=torch.float32))
    return (f"{float((counts > 0).sum(2).float().mean()):.1f} distinct codes, largest group "
            f"{float(counts.max(2).values.mean()):.1f}")


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
        raise SystemExit("tune_cat_split needs a CUDA device")
    dev = torch.device("cuda")
    n, b = N_SAMPLES, N_FEATURES
    rng = np.random.default_rng(0)
    blocks = {"lbp": lbp_block(dev, n, b),
              "skewed": torch.from_numpy(skewed_codes(rng, b, n)).to(dev),
              "uniform": torch.from_numpy(rng.integers(0, 256, (b, n)).astype(np.int32)).to(dev),
              "one_code": (torch.arange(b, device=dev, dtype=torch.int32) % 256)[:, None]
              .expand(b, n).contiguous()}
    w = torch.from_numpy(rng.random(n) ** 3).to(dev)
    wm = w / w.sum() * torch.from_numpy(rng.random(n) > 0.1).to(dev)
    rm = wm * torch.from_numpy(rng.choice([-1.0, 1.0], n)).to(dev)
    q = torch.empty(b, dtype=torch.float64, device=dev)
    sub = torch.empty((b, 8), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for dist, codes in blocks.items():
        print(f"{dist}: {window_stats(codes)} a window of 32", flush=True)
    libs = build_all()
    print(f"{smi}; {b} features x {n} samples, regression; ms over {REPS} launches after one")
    want = {}
    for name, lib in libs.items():
        slots = ctypes.c_int(0)
        _build.check(lib.cct_cat_split_slots(n, ctypes.byref(slots)), "cct_cat_split_slots")
        row = []
        for dist, codes in blocks.items():
            def run(lib=lib, codes=codes):
                _build.check(lib.cct_cat_split(codes.data_ptr(), wm.data_ptr(), rm.data_ptr(), n,
                                               b, 0, q.data_ptr(), sub.data_ptr(), stream),
                             "cct_cat_split")
            ms = cuda_ms(run)
            got = (q.clone(), sub.clone())
            want.setdefault(dist, got)
            same = all(torch.equal(x, y) for x, y in zip(got, want[dist]))
            row.append(f"{dist} {ms:.4f} ms same {same}")
        print(f"{name:15s} {slots.value:5d} warps a wave; " + "; ".join(row), flush=True)


if __name__ == "__main__":
    main()
