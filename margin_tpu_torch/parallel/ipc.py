"""Cross-process scoring service: host worker processes feed one device.

Counterpart of `margin_tpu/parallel/ipc.py`. A Python host is GIL-bound,
so `--workers process -t N` runs the chunks in N worker processes, while
the card belongs to the parent alone:

  * the parent runs a `ScoreServer`, a unix-socket listener whose
    per-worker handler threads call `executor.score_pairs` and
    `banded.banded_posteriors_many` on the parent's device, where the
    combining services (`_PairScoreService`, `_FbFunnel`) merge the
    workers' concurrent requests into shared launches;
  * each worker runs the whole chunk pipeline with `--device cpu` and a
    `ScoreClient` installed in `executor`, so its pair scoring and its
    banded batches go over the socket (a worker solves only the bands the
    parent would send to its own host engine);
  * chunk results travel through the shard checkpoint directory, and the
    parent finishes with the ordinary `--shard merge` pass, so process
    mode writes what `-t N` thread mode writes (both use the per-chunk
    RNG streams).

Transport is `multiprocessing.connection` (pickled numpy) over AF_UNIX with
a random authkey.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import traceback
from typing import Dict, List

import numpy as np

_TABLE_KEYS = ("match", "gap_x", "gap_y", "trans", "repeat")


def _tables_payload(tables) -> dict:
    """PairHmmTables -> numpy arrays (tensors stay in their process)."""
    return dict(tables.host)


def _tables_digest(payload: dict) -> str:
    h = hashlib.sha256()
    for k in _TABLE_KEYS:
        h.update(k.encode())
        if payload[k] is not None:
            h.update(np.ascontiguousarray(payload[k]).tobytes())
    return h.hexdigest()


class ScoreServer:
    """Parent-side scoring service over a unix socket, scoring on
    `device` (the parent's resolved device)."""

    def __init__(self, device):
        from multiprocessing.connection import Listener
        self.device = device
        self._dir = tempfile.mkdtemp(prefix="margin_score_")
        self.address = os.path.join(self._dir, "sock")
        self.authkey = os.urandom(20)
        self._listener = Listener(self.address, family="AF_UNIX",
                                  authkey=self.authkey)
        self._tables: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._accept.start()

    def _accept_loop(self):
        while True:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _shared_tables(self, payload: dict):
        """One tables object on the server's device per distinct content:
        the combining services merge requests by the tables' identity, so
        every worker's requests meet."""
        from margin_tpu_torch.ops import pairhmm
        digest = _tables_digest(payload)
        with self._lock:
            t = self._tables.get(digest)
            if t is None:
                t = self._tables[digest] = pairhmm.tables_from_numpy(
                    *(payload[k] for k in _TABLE_KEYS), device=self.device)
        return t

    def _serve(self, conn):
        from margin_tpu_torch.ops import banded
        from margin_tpu_torch.parallel import executor

        conn_tables: Dict[int, object] = {}
        try:
            while True:
                msg = conn.recv()
                kind = msg[0]
                try:
                    if kind == "tables":
                        _, key, payload = msg
                        conn_tables[key] = self._shared_tables(payload)
                        continue
                    if kind == "score":
                        _, key, pairs, strands, reps, use_lut, batch_max = msg
                        out = executor.score_pairs(
                            conn_tables[key], pairs, strands, rep_pairs=reps,
                            use_lut=use_lut, batch_max=batch_max)
                    elif kind == "banded":
                        _, key, items, expansion, threshold, use_lut, dyn = \
                            msg
                        out = banded.banded_posteriors_many(
                            conn_tables[key], items, expansion,
                            threshold=threshold, use_lut=use_lut,
                            dynamic=dyn)
                    else:
                        raise ValueError(f"unknown request {kind!r}")
                    conn.send(("ok", out))
                except Exception:   # the worker raises it, with this
                    conn.send(("err", traceback.format_exc(limit=-6)))
        except (EOFError, OSError):
            pass
        finally:
            conn.close()

    def close(self):
        try:
            self._listener.close()
        except OSError:
            pass
        shutil.rmtree(self._dir, ignore_errors=True)

    def env(self) -> dict:
        """Environment variables that point a worker at this server."""
        return {"MARGIN_TPU_SCORE_SERVER": self.address,
                "MARGIN_TPU_SCORE_AUTH": self.authkey.hex()}


class ScoreClient:
    """Worker-side end of the socket, installed into executor."""

    def __init__(self, address: str, authkey: bytes):
        from multiprocessing.connection import Client
        self._conn = Client(address, family="AF_UNIX", authkey=authkey)
        self._lock = threading.Lock()
        self._sent: set = set()

    def _call(self, tables, msg):
        key = id(tables)
        with self._lock:
            if key not in self._sent:
                self._conn.send(("tables", key, _tables_payload(tables)))
                self._sent.add(key)
            self._conn.send((msg[0], key) + msg[1:])
            status, out = self._conn.recv()
        if status != "ok":
            raise RuntimeError(f"score server error: {out}")
        return out

    def score(self, tables, pairs, strands, reps, use_lut, batch_max):
        return self._call(tables, (
            "score", [(np.asarray(x), np.asarray(y)) for x, y in pairs],
            [int(s) for s in strands],
            None if reps is None else
            [(np.asarray(a), np.asarray(b)) for a, b in reps],
            bool(use_lut), int(batch_max)))

    def banded(self, tables, items, expansion, threshold, use_lut, dynamic):
        """A banded_posteriors_many batch; anchors ship as (n, 3) int64
        arrays."""
        wire = []
        for it in items:
            w = {"x_sym": np.asarray(it["x_sym"]),
                 "y_sym": np.asarray(it["y_sym"]),
                 "anchors": np.asarray(
                     [] if it["anchors"] is None else it["anchors"],
                     dtype=np.int64).reshape(-1, 3),
                 "strand": int(it["strand"])}
            for k in ("rep_x", "rep_y", "ragged_left", "ragged_right"):
                if it.get(k) is not None:
                    w[k] = it[k]
            wire.append(w)
        return self._call(tables, ("banded", wire, int(expansion),
                                   float(threshold), bool(use_lut),
                                   bool(dynamic)))


def maybe_install_client() -> bool:
    """Install a ScoreClient when MARGIN_TPU_SCORE_SERVER is set (a worker
    of run_process_workers). A server that cannot be reached raises: a
    worker never scores on its own."""
    addr = os.environ.get("MARGIN_TPU_SCORE_SERVER")
    if not addr:
        return False
    from margin_tpu_torch.parallel import executor
    auth = bytes.fromhex(os.environ.get("MARGIN_TPU_SCORE_AUTH", ""))
    executor.install_ipc_client(ScoreClient(addr, auth))
    return True


def run_process_workers(worker_argv: List[str], n_workers: int,
                        output_base: str, resume: bool, device,
                        log=print, profile: bool = False) -> List[str]:
    """Run `n_workers` `python -m margin_tpu_torch` processes, worker i on
    shard i/N of the chunks into <output_base>.checkpoint/, on the CPU,
    with their scoring served on `device` by this process. Returns when
    every shard is done; the caller then runs the ordinary shard merge.
    A worker that fails makes this raise with the end of its log. With
    profile=True each worker writes its stage timings to
    <output_base>.profile.worker<i>.json, and the paths of those files
    are returned for the caller to merge; otherwise the list is empty."""
    from margin_tpu_torch import _ext
    device = _ext.resolve_device(device)
    if not resume:
        # a stale checkpoint directory would race the workers' own meta
        # checks at startup
        shutil.rmtree(f"{output_base}.checkpoint", ignore_errors=True)
    # the host engines build once here, not in N workers at once
    _ext.build(list(_ext.NATIVE_ENGINES))
    server = ScoreServer(device)
    env = dict(os.environ)
    env.update(server.env())
    # each worker's host engines get their share of the cores
    share = str(max(1, (os.cpu_count() or 4) // max(1, n_workers)))
    env.setdefault("MARGIN_TPU_NATIVE_FB_THREADS", share)
    env.setdefault("MARGIN_TPU_IO_THREADS", share)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo_root, env.get("PYTHONPATH")) if p)
    procs, logs, profiles = [], [], []
    try:
        for i in range(n_workers):
            argv = list(worker_argv) + ["--shard", f"{i}/{n_workers}"]
            wenv = env
            if profile:
                argv.append("--profile")
                profiles.append(f"{output_base}.profile.worker{i}.json")
                wenv = dict(env, MARGIN_TPU_PROFILE_OUT=profiles[-1])
            # a worker's output spools to a file: pipes read one after
            # another could fill and stall a later worker
            lf = tempfile.TemporaryFile()
            logs.append(lf)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "margin_tpu_torch"] + argv, env=wenv,
                stdout=lf, stderr=subprocess.STDOUT))
        failures = []
        for i, p in enumerate(procs):
            if p.wait() != 0:
                logs[i].seek(0)
                failures.append((i, p.returncode,
                                 logs[i].read().decode(errors="replace")))
        if failures:
            i, rc, out = failures[0]
            tail = "\n".join(out.splitlines()[-25:])
            raise RuntimeError(
                f"process worker {i} exited with {rc} "
                f"({len(failures)}/{n_workers} failed):\n{tail}")
        log(f"> {n_workers} process workers finished; merging")
        return profiles
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lf in logs:
            lf.close()
        server.close()
