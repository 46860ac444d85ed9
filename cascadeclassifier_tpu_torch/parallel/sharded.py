"""Feature-sharded split search and sample-sharded evaluation over a mesh.

Counterpart of ``cascadeclassifier_tpu/parallel/sharded.py``. A
``FeatureMesh`` cuts an axis (the feature rows of the split search, or
the sample rows of an evaluation) into S shards:

  - an in-process mesh (``make_mesh``) holds every shard in this
    process, one device each; a device may repeat when the caller names
    it (``["cpu"] * 8``, the tests' counterpart of the JAX package's 8
    virtual CPU devices; ``["cuda:0"] * 4``, four shards on one card).
    Shards combine on the host: one fetch per device.
  - a process mesh (``init_distributed``) holds one shard a process, on
    that process's device. Shards combine through ``torch.distributed``:
    NCCL with CUDA tensors, gloo with CPU tensors.

Shard s of F rows holds rows [s·P, (s+1)·P), P = ⌈F/S⌉, zero-padded past
F (the JAX package's ``FeatureCache._place``). A feature's split
arithmetic never crosses rows, so a shard's qualities are the bits of
the whole block's, and the combine (the highest quality, ties to the
lowest global index: the reference's ascending feature scan) picks the
split the unsharded search picks. The trainer's own mesh path is
``train/boost.py`` (``FeatureCache(mesh=)``, ``StageTrainer(mesh=)``),
which keeps padding rows out of the combine; this module holds the mesh,
the shard layout, the combine and the JAX module's two stand-alone
collectives, each shard's work in the port's split kernel and f32
product.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from cascadeclassifier_tpu_torch.train.evaluators import f32_matmul
from cascadeclassifier_tpu_torch.train.split import split_scan_gather, tree_sum
from cascadeclassifier_tpu_torch.utils.profiling import SYNC, count


@dataclasses.dataclass
class FeatureMesh:
    """S shards of one axis: ``devices`` holds the device of each shard
    this process holds (all S in-process, one on a process mesh),
    ``group`` the process group of a process mesh (None in-process),
    ``rank`` this process's shard on a process mesh (0 in-process)."""

    devices: list
    group: object = None
    rank: int = 0
    size: int = 1
    axis: str = "feat"

    def __post_init__(self):
        self.devices = [torch.device(d) for d in self.devices]

    @property
    def shape(self) -> dict:
        """{axis: shards}, as a JAX mesh's ``shape``."""
        return {self.axis: self.size}

    @property
    def local_shards(self) -> list:
        """The global index of each shard this process holds."""
        return [self.rank] if self.group is not None else list(range(self.size))


def make_mesh(n_devices: int | None = None, axis: str = "feat", devices=None) -> FeatureMesh:
    """An in-process mesh over the first n_devices CUDA devices (all of
    them by default; fewer than asked raises), or over the first
    n_devices of ``devices``, which may repeat a device or name the CPU.
    Nothing repeats a device or goes to the CPU unless named."""
    if devices is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise RuntimeError(f"make_mesh: {n} CUDA devices asked, {count} present "
                               f"(devices= names others, or repeats one)")
        devices = [f"cuda:{i}" for i in range(n)]
    else:
        devices = list(devices)
        n = len(devices) if n_devices is None else n_devices
        if not 1 <= n <= len(devices):
            raise ValueError(f"make_mesh: {n} shards asked of {len(devices)} devices")
        devices = devices[:n]
    return FeatureMesh(devices=devices, size=n, axis=axis)


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: str | None = None, device=None, axis: str = "feat") -> FeatureMesh:
    """Join the process group of ``num_processes`` processes whose rank 0
    listens at ``coordinator`` (host:port) → this process's shard of a
    process mesh. ``device`` defaults to cuda:{process_id % cards} (no
    card raises: pass device="cpu" for the CPU). ``backend`` defaults to
    NCCL on a CUDA device and gloo on the CPU; two ranks on one card need
    gloo, named here (NCCL refuses them)."""
    if device is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("init_distributed: no CUDA device; pass device='cpu'")
        device = f"cuda:{process_id % count}"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return FeatureMesh(devices=[device], group=dist.group.WORLD, rank=process_id,
                       size=num_processes, axis=axis)


@contextlib.contextmanager
def process_mesh(mesh: FeatureMesh | None):
    """Scope of a process mesh's group (nothing for an in-process mesh or
    None): on a normal exit a barrier, so that no rank leaves while a peer
    still talks to it, then ``destroy_process_group``; on an exception the
    group is destroyed at once, and a peer waiting on this rank fails
    instead of hanging."""
    try:
        yield mesh
    except BaseException:
        if mesh is not None and mesh.group is not None and dist.is_initialized():
            dist.destroy_process_group()
        raise
    if mesh is not None and mesh.group is not None and dist.is_initialized():
        dist.barrier(group=mesh.group)
        dist.destroy_process_group()


def shard_span(n_rows: int, size: int, s: int):
    """(first row, real rows, rows a shard) of shard s when n_rows rows go
    to size shards of ⌈n_rows/size⌉ rows; rows past n_rows are padding."""
    per = -(-n_rows // size)
    lo = min(s * per, n_rows)
    return lo, min(lo + per, n_rows) - lo, per


def pad_rows(x, per: int):
    """x with zero rows appended up to per rows."""
    if x.shape[0] == per:
        return x
    return torch.cat([x, x.new_zeros((per - x.shape[0],) + tuple(x.shape[1:]))])


def on_device(dev: torch.device):
    """The context a kernel launch on dev runs in: the wrappers launch on
    the current CUDA device. Nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def shard_features(mesh: FeatureMesh, values, sort_idx=None):
    """Each local shard of the (F, ...) rows ``values`` and of their (F, N)
    sort order, zero-padded to ⌈F/S⌉ rows (a padding row's order is
    0..N−1, a zero row's stable sort), on its device → (list of values,
    list of orders or None). On a process mesh a rank may instead pass its
    own rows to the functions below."""
    values = torch.as_tensor(values)
    vs, si = [], []
    for s, dev in zip(mesh.local_shards, mesh.devices):
        lo, n, per = shard_span(values.shape[0], mesh.size, s)
        vs.append(pad_rows(values[lo:lo + n], per).to(dev))
        if sort_idx is not None:
            idx = torch.as_tensor(sort_idx)[lo:lo + n].to(torch.int64)
            pad = torch.arange(idx.shape[1], device=idx.device).expand(per - n, -1)
            si.append(torch.cat([idx, pad]).to(dev))
    return vs, (si if sort_idx is not None else None)


def gather_records(mesh: FeatureMesh | None, records: list) -> np.ndarray:
    """records: an (R, K) f64 tensor of each local shard, on its device →
    (S, R, K) numpy of every shard's, in shard order. In-process (or
    mesh None: one shard) one fetch a device; on a process mesh one
    ``all_gather`` (the tensor on the device under NCCL, on the CPU under
    gloo)."""
    if mesh is None or mesh.group is None:
        by_device = {}
        for k, r in enumerate(records):
            by_device.setdefault(r.device, []).append(k)
        out = [None] * len(records)
        count(SYNC, len(by_device))
        for ks in by_device.values():
            host = torch.stack([records[k] for k in ks]).cpu().numpy()
            for j, k in enumerate(ks):
                out[k] = host[j]
        return np.stack(out)
    (local,) = records
    count(SYNC)
    if dist.get_backend(mesh.group) != "nccl":
        local = local.cpu()
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    return torch.stack(parts).cpu().numpy()


def first_best(records: np.ndarray) -> np.ndarray:
    """The record (row) of the highest quality (column 0) among records in
    ascending global feature order; the first of equal ones."""
    return records[int(np.argmax(records[:, 0]))]


def _check_axis(mesh: FeatureMesh, axis: str):
    if mesh.axis != axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")


def sharded_ordered_best_split(mesh: FeatureMesh, axis: str = "feat"):
    """fn(values, sort_idx, w, resp, mask) → (quality f64, global var,
    threshold f32): the best ordered regression split over feature rows
    sharded on the mesh. values (P, N) f32 and sort_idx (P, N) are the
    local shards (lists, as ``shard_features`` returns them, or one
    rank's own rows); w, resp (N,) f64 and mask (N,) bool in sample order.
    Each shard runs ``split_scan_gather`` and takes its first maximum;
    the combine takes the highest quality, ties to the lowest global index
    (the JAX function's, with -inf and var 0 when nothing splits)."""
    from cascadeclassifier_tpu_torch.train.boost import best_of_block

    _check_axis(mesh, axis)

    def call(values, sort_idx, w, resp, mask):
        if torch.is_tensor(values):
            values, sort_idx = [values], [sort_idx]
        m = np.asarray(mask, bool)
        wm = np.where(m, np.asarray(w, np.float64), 0.0)
        rm = wm * np.asarray(resp, np.float64)
        tw, tr = tree_sum(wm), tree_sum(rm)
        records = []
        for s, dev, v, si in zip(mesh.local_shards, mesh.devices, values, sort_idx):
            with on_device(dev):
                v, si = v.to(dev), si.to(dev, torch.int64)
                vs = torch.gather(v, 1, si)
                q, thr = split_scan_gather(vs.t(), si.t(), torch.as_tensor(wm, device=dev),
                                           torch.as_tensor(rm, device=dev),
                                           torch.as_tensor(m, device=dev), tw, tr)
                qm, i = best_of_block(q)
                records.append(torch.stack([qm, (s * v.shape[0] + i).double(),
                                            thr[i].double()])[None])
        best = first_best(gather_records(mesh, records)[:, 0])
        return float(best[0]), int(best[1]), np.float32(best[2])

    return call


def sharded_batch_eval(mesh: FeatureMesh, axis: str = "data"):
    """fn(corner_m, sum_rows, w) → (vals, wsum): the evaluator's product
    with the corner matrix (F, P) on every shard and the integral rows
    (N, P) and weights (N,) sharded over samples (the local shards, as
    ``shard_features`` places them, or one rank's rows). vals (F, N') is
    the local shards' responses side by side (padding columns included) on
    the first local device; wsum (F,) is Σ vals @ w over every shard: added
    in shard order in-process, by ``all_reduce`` on a process mesh."""
    _check_axis(mesh, axis)

    def call(corner_m, sum_rows, w):
        if torch.is_tensor(sum_rows):
            sum_rows, w = [sum_rows], [w]
        home = mesh.devices[0]
        vals, wsum = [], None
        for dev, rows, wl in zip(mesh.devices, sum_rows, w):
            v = f32_matmul(torch.as_tensor(corner_m).to(dev), rows.to(dev).T)
            part = f32_matmul(v, wl.to(dev)).to(home)
            vals.append(v.to(home))
            wsum = part if wsum is None else wsum + part
        if mesh.group is not None:
            t = wsum if dist.get_backend(mesh.group) == "nccl" else wsum.cpu()
            dist.all_reduce(t, group=mesh.group)
            wsum = t.to(home)
        return torch.cat(vals, dim=1), wsum

    return call
