"""Sharding of pair scoring over a (dp, sp) grid of CUDA devices.

Counterpart of `margin_tpu/parallel/mesh.py`. The reference's parallelism
is OpenMP over genomic chunks (phase.c:276-279); the mesh adds a second
level inside the scoring calls:

  - axes ("dp", "sp"): the pair axis of a batch is split over the whole
    grid, row-major (the order of the JAX package's `P(("dp", "sp"))`),
    one contiguous shard a device;
  - every device runs kernel K1 (`pairhmm.forward_total`) on its shard;
  - the per-slot allele-support sums, the JAX package's `psum` over both
    axes, are the shards' partial sums added on the grid's first device
    in shard order, and the scores are gathered there.

A device list may repeat a device: `[cuda:0] * 4` runs every split, pad,
launch, gather and reduce on one card (and `[cpu] * 8` on the CPU, where
K1's plain twin runs), as the JAX package's virtual CPU mesh does.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from margin_tpu_torch.ops import pairhmm


@dataclass(frozen=True, eq=False)
class Mesh:
    """devices: (dp, sp) numpy object array of torch.devices."""
    devices: np.ndarray
    axis_names: tuple = ("dp", "sp")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> List[torch.device]:
        """The devices in shard order (row-major)."""
        return list(self.devices.reshape(-1))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """2D (dp, sp) mesh over `devices` (default: every visible CUDA
    device; no card and no list raises). dp favours the first axis, sp
    gets the residual (mesh.py:31-40): n = 1, 2, 4, 8 give (1, 1),
    (2, 1), (2, 2), (4, 2)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= to "
                "build a mesh of other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"make_mesh({n}): only {len(devices)} devices")
    if dp is None:
        dp = max(d for d in range(1, n + 1) if n % d == 0 and d * d <= n * 2)
    sp = n // dp
    grid = np.empty(dp * sp, dtype=object)
    for i in range(dp * sp):
        grid[i] = devices[i]
    return Mesh(grid.reshape(dp, sp))


_FIELDS = ("xs", "ys", "lxs", "lys", "strands", "ragged_left",
           "ragged_right", "rep_x", "rep_y")


def shard_batch(batch: pairhmm.PairBatch,
                mesh: Mesh) -> List[pairhmm.PairBatch]:
    """The batch padded (executor.pad_batch) to a multiple of mesh.size
    and cut along its pair axis into mesh.size contiguous shards, shard k
    on mesh.flat[k]."""
    from margin_tpu_torch.parallel.executor import pad_batch
    batch = pad_batch(batch, mesh.size)
    per = batch.xs.shape[0] // mesh.size

    def cut(t, k, dev):
        return None if t is None else t[k * per:(k + 1) * per].to(dev)
    return [pairhmm.PairBatch(*(cut(getattr(batch, f), k, dev)
                                for f in _FIELDS))
            for k, dev in enumerate(mesh.flat)]


class Replicas:
    """Copies of tables objects on other devices, made once per (tables
    object, device). The cache holds each tables object it keys, so its
    id cannot be reused by another while the entry lives."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_id = {}

    def on(self, tables: pairhmm.PairHmmTables,
           dev: torch.device) -> pairhmm.PairHmmTables:
        if tables.device == dev:
            return tables
        with self._lock:
            _, copies = self._by_id.setdefault(id(tables), (tables, {}))
            t = copies.get(dev)
            if t is None:
                t = copies[dev] = pairhmm.PairHmmTables(
                    *(None if a is None else a.to(dev) for a in (
                        tables.match, tables.gap_x, tables.gap_y,
                        tables.trans, tables.repeat)))
        return t


def forward_shards(replicas: Replicas, tables, shards, use_lut: bool):
    """K1 on every shard, each on its own device; every shard launches
    before any result is read."""
    return [pairhmm.forward_total(replicas.on(tables, s.xs.device), s,
                                  use_lut=use_lut) for s in shards]


def gather(parts, dev: torch.device) -> torch.Tensor:
    """The shards' results concatenated in shard order on `dev`."""
    return torch.cat([p.to(dev) for p in parts])


def slot_sums(scores, slot_idx, n_slots: int,
              dev: torch.device) -> torch.Tensor:
    """Each shard's float32 segment sum of its scores (a list in shard
    order) into n_slots, then the partials added on `dev` in shard order.
    slot_idx labels the batch's pairs; pad lanes (beyond it) go to slot
    0, where their score, 0, adds nothing."""
    if isinstance(slot_idx, torch.Tensor):
        idx = slot_idx.to("cpu", torch.int64)
    else:
        idx = torch.as_tensor(np.asarray(slot_idx, np.int64))
    total = sum(sc.shape[0] for sc in scores)
    if idx.numel() < total:
        idx = torch.cat([idx, idx.new_zeros(total - idx.numel())])
    out, at = None, 0
    for sc in scores:
        part = torch.zeros(n_slots, dtype=torch.float32, device=sc.device)
        n = sc.shape[0]
        part.index_add_(0, idx[at:at + n].to(sc.device), sc)
        at += n
        out = part.to(dev) if out is None else out + part.to(dev)
    return out


def phase_step_sharded(mesh: Mesh, n_slots: int):
    """The multi-device phase step (mesh.py:55-87):

    (tables, sharded, slot_idx) -> (scores (B,), slot_sums (n_slots,))

    `sharded` is shard_batch's list, slot_idx each pair's (bubble,
    allele) accumulation slot. K1 runs on every shard's device, each
    shard sums its scores into the slots, and the partials are reduced
    on mesh.flat[0], where the scores are gathered too."""
    replicas = Replicas()
    root = mesh.flat[0]

    def step(tables, sharded, slot_idx):
        scores = forward_shards(replicas, tables, sharded, use_lut=False)
        sums = slot_sums(scores, slot_idx, n_slots, root)
        return gather(scores, root), sums
    return step
