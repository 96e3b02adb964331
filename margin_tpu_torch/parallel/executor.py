"""Pair scoring on one device, with cross-thread launch coalescing.

Counterpart of `margin_tpu/parallel/executor.py`: `score_pairs` and the
combining service `_PairScoreService` (executor.py:259-340). The JAX
package's mesh context, `shard_map` and worker-process client are not
ported (ROADMAP queue 1, "IPC workers, multi-GPU and multi-host").
Batches are built on the device the tables live on.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from margin_tpu_torch.ops import pairhmm


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


def score_batch(tables, batch: pairhmm.PairBatch,
                use_lut: bool = False) -> np.ndarray:
    """Total forward log-probs of one batch as a host (B,) float32 array."""
    t0 = time.perf_counter()
    out = pairhmm.forward_total(tables, batch, use_lut=use_lut).cpu().numpy()
    b, lx = batch.xs.shape
    ly = batch.ys.shape[1]
    DEVICE_STATS.add(b, b * (lx + ly) * (ly + 1), time.perf_counter() - t0)
    return out


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
                sel_pairs = [reqs[ri].pairs[i] for ri, i in part]
                sel_strands = np.array(
                    [reqs[ri].strands[i] for ri, i in part], np.int32)
                sel_reps = ([reqs[ri].reps[i] for ri, i in part]
                            if use_rle else None)
                batch = pairhmm.make_batch(sel_pairs, strands=sel_strands,
                                           rep_pairs=sel_reps,
                                           device=tables.device)
                scores = score_batch(tables, batch, use_lut=use_lut)
                for (ri, i), s in zip(part, scores):
                    reqs[ri].out[i] = s
        except BaseException as e:  # surface on every waiter
            for r in reqs:
                r.error = e


_SCORER = _PairScoreService()


def score_pairs(tables, pairs, strands, rep_pairs=None, use_lut: bool = False,
                batch_max: int = 32768) -> np.ndarray:
    """Score a list of (x_sym, y_sym) pairs on the tables' device,
    coalescing concurrent callers into shared launches. Returns
    (len(pairs),) float32 scores in request order."""
    return _SCORER.score(tables, pairs, strands, rep_pairs, use_lut,
                         batch_max)
