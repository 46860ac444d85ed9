"""Run one benchmark cell once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the CUDA context, the
program's kernel build from its cache in the checkout, the inputs made
from the seed, a warm-up of every shape the cell uses) is timed as
``setup_s``; then the cell's driver measures for ``--seconds`` and,
once the window has closed, holds what the timed path produced against
the benchmark's plain reference. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit; the same checks end standard error.

It exits non-zero and prints no result where there is no CUDA device or
fewer than the cell asks for, where the program is not in the checkout,
and where JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import os  # noqa: E402

# one process, one host thread: the host paces these cells, and a pool of
# threads makes each run's pace hang on what else the host runs
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import guard, manifest  # noqa: E402

PROGRAM = "cascadeclassifier_tpu_torch"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _fail(code: int, msg: str):
    log(f"benchmark: {msg}")
    sys.exit(code)


def _cache_dirs(root: str):
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = manifest.ROOT
    if not os.path.isfile(os.path.join(root, PROGRAM, "__init__.py")):
        _fail(2, f"the program ({PROGRAM}/) is not in this checkout")
    found = guard.forbidden_modules()
    if found:
        _fail(4, f"forbidden modules loaded before set-up: {found}")
    _cache_dirs(root)
    spec = manifest.cell(manifest.load(root), args.workload)

    import torch

    torch.set_num_threads(1)
    need = int(spec["entry"]["chips"])
    if not torch.cuda.is_available():
        _fail(3, "no CUDA device")
    if torch.cuda.device_count() < need:
        _fail(3, f"the cell needs {need} CUDA devices, {torch.cuda.device_count()} present")

    driver = importlib.import_module("benchmark.drivers." + spec["cell"]["driver"])
    res = driver.run(spec, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     t0=T0, log=log)

    found = guard.forbidden_modules()
    if found:
        _fail(4, f"forbidden modules loaded by the run: {found}")

    names = [m["name"] for m in (spec["per_layer"] if args.trace else spec["end_to_end"])]
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    metrics = {n: {"value": res["metrics"][n], "unit": units[n]}
               for n in names if res["metrics"].get(n) is not None}
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": res["device"]}
    if args.trace and res.get("breakdown"):
        out["breakdown"] = res["breakdown"]
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in res["checks"]}
    for c in res["checks"]:
        log(f"check {c['name']}: {c['value']} (limit {c['limit']}, {c['rule']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
