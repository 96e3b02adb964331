"""Process-global scoring context: one device or a (dp, sp) device mesh,
with cross-thread launch coalescing.

Counterpart of `margin_tpu/parallel/executor.py`. Chunk orchestration
stays on host threads; the dense pair-scoring batches that every chunk's
bubble construction, het-group scoring and filtered-read partitioning
produce go through `_CTX`:

  * with no mesh (the default, and any single-device run) a batch runs
    kernel K1 on the device it was built on, as it always has;
  * `enable_mesh()` installs a `DeviceContext` over a `parallel/mesh.py`
    grid: each batch's pair axis is split over every device, K1 runs on
    each shard, and the scores are gathered back in order;
  * `score_slot_sums` adds each slot's scores on every shard and reduces
    the partials across the grid.

The drivers enable a mesh themselves when more than one CUDA device is
visible. `score_pairs`, the combining service `_PairScoreService` and the
worker-process client hooks (`install_ipc_client`, `has_ipc_client`,
`ipc_banded`) score through the context. Batches are built on the device
the tables live on.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from margin_tpu_torch.ops import pairhmm
from margin_tpu_torch.parallel import mesh as meshmod
from margin_tpu_torch.utils import profiling


class DeviceStats:
    """Cheap accounting of scoring launches: launches, pair/cell counts and
    the host seconds spent waiting for their results (launch + readback)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0
        self.pairs = 0
        self.cells = 0
        self.wait_s = 0.0

    def add(self, pairs: int, cells: int, wait_s: float):
        with self._lock:
            self.launches += 1
            self.pairs += pairs
            self.cells += cells
            self.wait_s += wait_s

    def snapshot(self) -> dict:
        with self._lock:
            return {"launches": self.launches, "pairs": self.pairs,
                    "cells": self.cells, "device_wait_s": round(self.wait_s, 3)}

    def reset(self):
        with self._lock:
            self.launches = 0
            self.pairs = 0
            self.cells = 0
            self.wait_s = 0.0


DEVICE_STATS = DeviceStats()


class DeviceContext:
    """Scoring executor. mesh=None -> the batch's own device."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self._replicas = meshmod.Replicas()

    @property
    def n_shards(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    def _sharded(self, tables, batch, use_lut):
        """K1's scores of each shard of the padded batch, on the shard's
        device: every shard launched before any is read."""
        shards = meshmod.shard_batch(batch, self.mesh)
        return meshmod.forward_shards(self._replicas, tables, shards,
                                      use_lut)

    def score_batch(self, tables, batch: pairhmm.PairBatch,
                    use_lut: bool = False) -> np.ndarray:
        """Total forward log-probs of one batch as a host (B,) float32
        array; sharded over the mesh when one is installed."""
        t0 = time.perf_counter()
        b0 = batch.xs.shape[0]
        with profiling.span("k1.device", b0):
            if self.mesh is None:
                out = pairhmm.forward_total(tables, batch,
                                            use_lut=use_lut).cpu().numpy()
                b = b0
            else:
                scores = self._sharded(tables, batch, use_lut)
                out = torch.cat([s.cpu() for s in scores]).numpy()[:b0]
                b = sum(s.shape[0] for s in scores)
        lx = batch.xs.shape[1]
        ly = batch.ys.shape[1]
        DEVICE_STATS.add(b, b * (lx + ly) * (ly + 1),
                         time.perf_counter() - t0)
        return out

    def score_slot_sums(self, tables, batch: pairhmm.PairBatch, slot_idx,
                        n_slots: int, use_lut: bool = False):
        """(per-pair scores, per-slot score sums) on the host. One device:
        a host segment sum; a mesh: each shard's float32 partial sums,
        reduced on the mesh's first device."""
        b0 = batch.xs.shape[0]
        if self.mesh is None:
            with profiling.span("k1.device", b0):
                scores = pairhmm.forward_total(tables, batch,
                                               use_lut=use_lut).cpu().numpy()
            sums = np.zeros(n_slots, dtype=scores.dtype)
            np.add.at(sums, np.asarray(slot_idx), scores)
            return scores, sums
        with profiling.span("k1.device", b0):
            scores = self._sharded(tables, batch, use_lut)
            root = self.mesh.flat[0]
            sums = meshmod.slot_sums(scores, slot_idx, n_slots, root)
            return (meshmod.gather(scores, root).cpu().numpy()[:b0],
                    sums.cpu().numpy())


def pad_batch(batch: pairhmm.PairBatch, multiple: int) -> pairhmm.PairBatch:
    """The pair axis padded to a multiple of `multiple` with empty
    (length-0) problems, which score LOG_ONE = 0: symbols 4, lengths,
    strands and run lengths 0, no ragged ends (executor.py:188-192)."""
    b = batch.xs.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return batch

    def pad(t, fill):
        if t is None:
            return None
        block = torch.full((rem,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                           device=t.device)
        return torch.cat([t, block])

    return pairhmm.PairBatch(
        pad(batch.xs, 4), pad(batch.ys, 4), pad(batch.lxs, 0),
        pad(batch.lys, 0), pad(batch.strands, 0),
        pad(batch.ragged_left, False), pad(batch.ragged_right, False),
        pad(batch.rep_x, 0), pad(batch.rep_y, 0))


_CTX = DeviceContext()


def context() -> DeviceContext:
    return _CTX


def install(ctx: DeviceContext) -> None:
    """Make `ctx` the process's scoring context (a one-device mesh keeps
    the drivers' switch from installing another)."""
    global _CTX
    _CTX = ctx


def enable_mesh(n_devices: Optional[int] = None, log=None,
                devices=None) -> bool:
    """Install a mesh-sharded context over `devices` (default: every
    visible CUDA device). Returns True if a mesh of more than one device
    was installed; with one device the context is the plain one."""
    global _CTX
    if devices is None:
        n = n_devices or torch.cuda.device_count()
    else:
        n = n_devices or len(devices)
    if n <= 1:
        _CTX = DeviceContext()
        return False
    mesh = meshmod.make_mesh(n, devices=devices)
    _CTX = DeviceContext(mesh)
    if log is not None:
        kinds = sorted({d.type for d in mesh.flat})
        log(f"> Device mesh: {mesh.shape} over {mesh.size} "
            f"{'/'.join(kinds)} devices")
    return True


def auto_mesh(device, log=None) -> bool:
    """The drivers' mesh switch (phase/driver.py:146-152,
    polish/driver.py:217-223): a mesh over every visible CUDA device when
    no mesh is installed (an explicitly enabled one stays), `device` is
    CUDA and more than one card is visible. Returns whether it installed
    one."""
    if (_CTX.mesh is not None or torch.device(device).type != "cuda"
            or torch.cuda.device_count() <= 1):
        return False
    return enable_mesh(log=log)


def disable_mesh() -> None:
    global _CTX
    _CTX = DeviceContext()


def score_batch(tables, batch: pairhmm.PairBatch,
                use_lut: bool = False) -> np.ndarray:
    """Total forward log-probs of one batch as a host (B,) float32 array,
    through the installed context."""
    return _CTX.score_batch(tables, batch, use_lut=use_lut)


def score_slot_sums(tables, batch, slot_idx, n_slots: int,
                    use_lut: bool = False):
    """(per-pair scores, per-slot score sums) through the installed
    context."""
    return _CTX.score_slot_sums(tables, batch, slot_idx, n_slots,
                                use_lut=use_lut)


class _ScoreRequest:
    __slots__ = ("tables", "pairs", "strands", "reps", "use_lut",
                 "batch_max", "out", "done", "error")

    def __init__(self, tables, pairs, strands, reps, use_lut, batch_max):
        self.tables = tables
        self.pairs = pairs
        self.strands = strands
        self.reps = reps
        self.use_lut = use_lut
        self.batch_max = batch_max
        self.out = np.empty(len(pairs), dtype=np.float32)
        self.done = False
        self.error = None

    def key(self):
        return (id(self.tables), self.use_lut, self.reps is not None)


class _PairScoreService:
    """Combining funnel for pair-scoring requests.

    Chunk threads each issue scoring batches against the one device. The
    thread that finds the device free becomes the dispatcher, drains every
    compatible queued request, scores them as one concatenated batch and
    distributes results. Per-pair scores do not depend on batch makeup: a
    pair's DP never reads another pair, and the kernel walks each pair's
    own lx+ly, so coalescing cannot change any output.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue = []
        self._busy = False

    def score(self, tables, pairs, strands, reps, use_lut, batch_max):
        req = _ScoreRequest(tables, list(pairs), strands, reps, use_lut,
                            batch_max)
        if not req.pairs:
            return req.out
        with self._cond:
            self._queue.append(req)
            while not req.done:
                if self._busy:
                    # a launch is in flight; the next dispatcher takes us
                    with profiling.span("k1.queue"):
                        while self._busy and not req.done:
                            self._cond.wait()
                    continue
                mine = [r for r in self._queue if r.key() == req.key()]
                self._queue = [r for r in self._queue
                               if r.key() != req.key()]
                self._busy = True
                self._cond.release()  # let other threads enqueue mid-launch
                try:
                    self._run(mine)
                finally:
                    self._cond.acquire()
                    self._busy = False
                    for r in mine:
                        r.done = True
                    self._cond.notify_all()
        if req.error is not None:
            raise req.error
        return req.out

    def _run(self, reqs):
        """Score the union of `reqs` (all same key), sorted by length and
        cut into batches of at most batch_max pairs."""
        try:
            tables = reqs[0].tables
            use_lut = reqs[0].use_lut
            use_rle = reqs[0].reps is not None
            batch_max = min(r.batch_max for r in reqs)
            flat = [(ri, i) for ri, r in enumerate(reqs)
                    for i in range(len(r.pairs))]
            flat.sort(key=lambda t: (len(reqs[t[0]].pairs[t[1]][0]),
                                     len(reqs[t[0]].pairs[t[1]][1])))
            for s0 in range(0, len(flat), batch_max):
                part = flat[s0:s0 + batch_max]
                with profiling.span("k1.batch", len(part)):
                    sel_pairs = [reqs[ri].pairs[i] for ri, i in part]
                    sel_strands = np.array(
                        [reqs[ri].strands[i] for ri, i in part], np.int32)
                    sel_reps = ([reqs[ri].reps[i] for ri, i in part]
                                if use_rle else None)
                    batch = pairhmm.make_batch(
                        sel_pairs, strands=sel_strands, rep_pairs=sel_reps,
                        device=tables.device)
                scores = _CTX.score_batch(tables, batch, use_lut=use_lut)
                for (ri, i), s in zip(part, scores):
                    reqs[ri].out[i] = s
        except BaseException as e:  # surface on every waiter
            for r in reqs:
                r.error = e


_SCORER = _PairScoreService()
_IPC_CLIENT = None


def install_ipc_client(client) -> None:
    """Route score_pairs and banded_posteriors_many over an IPC connection
    to the device-owning parent (parallel/ipc.py). Process workers only."""
    global _IPC_CLIENT
    _IPC_CLIENT = client


def has_ipc_client() -> bool:
    return _IPC_CLIENT is not None


def score_pairs(tables, pairs, strands, rep_pairs=None, use_lut: bool = False,
                batch_max: int = 32768) -> np.ndarray:
    """Score a list of (x_sym, y_sym) pairs on the tables' device,
    coalescing concurrent callers into shared launches; in a process
    worker, on the parent's device. Returns (len(pairs),) float32 scores
    in request order."""
    if _IPC_CLIENT is not None and len(pairs) > 0:
        return _IPC_CLIENT.score(tables, pairs, strands, rep_pairs, use_lut,
                                 batch_max)
    return _SCORER.score(tables, pairs, strands, rep_pairs, use_lut,
                         batch_max)


def ipc_banded(tables, items, expansion, threshold, use_lut, dynamic):
    """A process worker's banded_posteriors_many batch, solved on the
    parent's device, where the funnel merges it with the other workers'."""
    return _IPC_CLIENT.banded(tables, items, expansion, threshold, use_lut,
                              dynamic)
