"""Times the two-class split wrapper ``train/split.py::
split_scan_class_gather`` through its public interface only, so that it
also times an older tree's kernel:

    python3 -m cascadeclassifier_tpu_torch.utils.time_split_class
    PYTHONPATH=<other tree> \
        python3 <this tree>/cascadeclassifier_tpu_torch/utils/time_split_class.py

Needs a CUDA device and nvcc. The block is ``utils/tune_split.py``'s, 32 768
features x 3 072 samples (values of 1 000 levels, so with ties; 90 % of the
samples masked in), with classes half and half; both policies, on
``torch.sort``'s (B, N) outputs seen transposed (the trainer's path) and on
a contiguous (N, B) block. Each call is timed with CUDA events over 20
calls after one (``ms``) and by the kernels' device time from
torch.profiler (``device``); a digest of the outputs' bytes shows that two
trees give the same bits. This module imports nothing of the package at
its top, so that it runs against an older tree.
"""

from __future__ import annotations

import hashlib
import subprocess

import torch

KERNELS = ("split_class_kernel", "split_scan_kernel")


def main():
    import cascadeclassifier_tpu_torch
    from cascadeclassifier_tpu_torch.train.split import split_scan_class_gather, tree_sum
    from cascadeclassifier_tpu_torch.utils.time_hog import cuda_ms, device_ms

    if not torch.cuda.is_available():
        raise SystemExit("time_split_class needs a CUDA device")
    dev = torch.device("cuda")
    n, b = 3072, 32768
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
    t1 = tree_sum(wm.cpu().numpy()) - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; the package at {cascadeclassifier_tpu_torch.__file__}; {b} features x {n} "
          "samples; ms over 20 calls after one", flush=True)
    layouts = {"fresh (B, N)": (vs_bn.t(), si_bn.t()),
               "resident (N, B)": (vs_bn.t().contiguous(), si_bn.t().contiguous())}
    for gini in (False, True):
        for lay, (vs, order) in layouts.items():
            def fn(vs=vs, order=order):
                return split_scan_class_gather(vs, order, w0, w1, mask, t0, t1, gini)

            q, thr = fn()
            digest = hashlib.sha256(q.cpu().numpy().tobytes() + thr.cpu().numpy().tobytes())
            ms, d = cuda_ms(fn), device_ms(fn, KERNELS)
            print(f"{'Gini' if gini else 'misclassification':17s} {lay:16s} {ms:.4f} ms, device "
                  + ", ".join(f"{k} {v:.4f}" for k, v in d.items() if v)
                  + f" ms; outputs {digest.hexdigest()[:16]}", flush=True)


if __name__ == "__main__":
    main()
