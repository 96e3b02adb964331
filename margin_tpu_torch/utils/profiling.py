"""Structured per-chunk / per-stage timing and nested spans (SURVEY §5
tracing row).

The reference only has ad-hoc wall-clock prints (phase.c:309-321,
polish.c:508-518, getTimeDescriptorFromSeconds misc.c:13). The port
replaces those with a structured profiler: every pipeline stage, every
chunk stage and every span opened below them is a span record (name,
start and end on `time.perf_counter_ns()`, parent span, chunk, thread,
work count), and the stages' and chunks' wall seconds are summed as
before. Each span's count, seconds, self seconds and work add up as it
closes; the first MAX_RECORDS records are kept besides, so a genome-scale
run holds a bounded list (a `torch.profiler` trace holds every span).

Usage:
    prof = Profiler(enabled=True)
    with prof.stage("vcf_parse"): ...
    with prof.chunk_stage(chunk_idx, "readextract"):
        ...
        with profiling.span("banded.pack", work=len(items)): ...
    prof.write("out.profile.json")

`span` records into the profiler whose stage or chunk stage is open on
the calling thread; `stage` and `chunk_stage` make their profiler the
thread's for their extent, and only when it is enabled. With none open,
`span` costs one thread-local read. An enabled span also opens
`torch.profiler.record_function(name)`, so a `torch.profiler` trace holds
every span as a `user_annotation` event on the clock of the device's
kernels and copies. A thread that opens no stage (a pool thread of a
host engine) records nothing.

Thread-safe: chunk records may be written from a worker pool.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List

from torch.profiler import record_function

RECORD_FIELDS = ("name", "start_ns", "end_ns", "parent", "chunk", "thread",
                 "work")

# span records an enabled profiler keeps (the first ones opened); the span
# totals count every span whatever the cap
MAX_RECORDS = 100_000


class _Record:
    __slots__ = RECORD_FIELDS + ("idx", "child_ns")

    def __init__(self, idx, name, start_ns, parent, chunk, thread, work):
        self.idx = idx
        self.name = name
        self.start_ns = start_ns
        self.end_ns = None
        self.parent = parent
        self.chunk = chunk
        self.thread = thread
        self.work = work
        self.child_ns = 0   # the seconds (ns) its direct children took

    def row(self) -> list:
        return [getattr(self, f) for f in RECORD_FIELDS]


class _Thread(threading.local):
    def __init__(self):
        self.prof = None    # the enabled Profiler a stage of which is open
        self.stack = []     # this thread's open span records, innermost last


_TLS = _Thread()
_NO_SPAN = nullcontext()

# what a closing span adds its seconds to, besides the span totals
_STAGE, _CHUNK = 1, 2


class _Span:
    __slots__ = ("prof", "name", "chunk", "work", "book", "rec", "rf")

    def __init__(self, prof, name, chunk, work, book=0):
        self.prof = prof
        self.name = name
        self.chunk = chunk
        self.work = work
        self.book = book

    def __enter__(self):
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.rec = self.prof._open(self.name, self.chunk, self.work,
                                   self.book)
        return self

    def __exit__(self, *exc):
        try:
            self.prof._close(self.rec, self.book)
        finally:
            self.rf.__exit__(*exc)
        return False


def span(name: str, work: int = 0):
    """A span of `name` (work: the pairs or items it handles) in the
    profiler that is active on this thread; nothing where none is."""
    prof = _TLS.prof
    if prof is None:
        return _NO_SPAN
    return _Span(prof, name, None, work)


def _zero() -> list:
    return [0, 0, 0, 0]     # n, total ns, self ns, work


class Profiler:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._t0 = time.time()
        self.stages: Dict[str, float] = {}
        self.chunks: Dict[int, Dict[str, float]] = {}
        self.records: List[_Record] = []    # the first MAX_RECORDS spans
        self._n_spans = 0                   # spans opened, kept or not
        self._totals: Dict[str, list] = {}  # name -> _zero(), closed spans
        self._merged_spans: Dict[str, dict] = {}   # workers' `spans`

    @contextmanager
    def _active(self):
        """This profiler is the calling thread's for the extent."""
        tls = _TLS
        prev = (tls.prof, tls.stack)
        if prev[0] is not self:
            tls.prof, tls.stack = self, []
        try:
            yield
        finally:
            tls.prof, tls.stack = prev

    def _open(self, name, chunk, work, book) -> _Record:
        stack = _TLS.stack
        parent = stack[-1] if stack else None
        if not book and parent is not None:
            chunk = parent.chunk
        start = time.perf_counter_ns()
        with self._lock:
            idx = self._n_spans
            self._n_spans += 1
            rec = _Record(idx, name, start,
                          parent.idx if parent is not None else -1, chunk,
                          threading.get_ident(), work)
            if idx < MAX_RECORDS:
                self.records.append(rec)
        stack.append(rec)
        return rec

    def _close(self, rec, book):
        end = time.perf_counter_ns()
        stack = _TLS.stack
        stack.pop()
        rec.end_ns = end
        dur = end - rec.start_ns
        if stack:
            stack[-1].child_ns += dur
        with self._lock:
            t = self._totals.get(rec.name)
            if t is None:
                t = self._totals[rec.name] = _zero()
            t[0] += 1
            t[1] += dur
            t[2] += dur - rec.child_ns
            t[3] += rec.work
            if book == _STAGE:
                self.stages[rec.name] = (self.stages.get(rec.name, 0.0)
                                         + dur / 1e9)
            elif book == _CHUNK:
                c = self.chunks.setdefault(rec.chunk, {})
                c[rec.name] = c.get(rec.name, 0.0) + dur / 1e9

    @contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        with self._active(), _Span(self, name, None, 0, _STAGE):
            yield

    @contextmanager
    def chunk_stage(self, chunk_idx: int, name: str):
        if not self.enabled:
            yield
            return
        with self._active(), _Span(self, name, chunk_idx, 0, _CHUNK):
            yield

    def span_totals(self) -> Dict[str, dict]:
        """{name: {n, total_s, self_s, work}} over the closed spans (self:
        the span's seconds less its direct children's), the workers' folded
        in."""
        with self._lock:
            own = {k: list(v) for k, v in self._totals.items()}
            merged = {k: dict(v) for k, v in self._merged_spans.items()}
        out = {k: {"n": n, "total_s": tot / 1e9, "self_s": slf / 1e9,
                   "work": w} for k, (n, tot, slf, w) in own.items()}
        for name, m in merged.items():
            s = out.setdefault(name, {"n": 0, "total_s": 0.0,
                                      "self_s": 0.0, "work": 0})
            for k in s:
                s[k] += m.get(k, 0)
        return {k: {"n": v["n"], "total_s": round(v["total_s"], 6),
                    "self_s": round(v["self_s"], 6), "work": v["work"]}
                for k, v in out.items()}

    def summary(self) -> dict:
        """Aggregate: total wall, per-stage totals, per-chunk-stage sums,
        per-span totals."""
        chunk_stage_totals: Dict[str, float] = {}
        for rec in self.chunks.values():
            for k, v in rec.items():
                chunk_stage_totals[k] = chunk_stage_totals.get(k, 0.0) + v
        return {
            "wall_s": round(time.time() - self._t0, 3),
            "stages_s": {k: round(v, 3) for k, v in self.stages.items()},
            "chunk_stage_totals_s": {k: round(v, 3)
                                     for k, v in chunk_stage_totals.items()},
            "n_chunks": len(self.chunks),
            "chunks": {str(k): {s: round(v, 4) for s, v in rec.items()}
                       for k, rec in sorted(self.chunks.items())},
            "spans": self.span_totals(),
        }

    def write(self, path: str):
        """The summary and this process's first MAX_RECORDS span records
        (`record_fields` names a record's columns; parent -1 for none, chunk
        null for a pipeline stage's; `records_dropped` counts those past the
        cap)."""
        if not self.enabled:
            return
        doc = self.summary()
        with self._lock:
            doc["record_fields"] = list(RECORD_FIELDS)
            doc["records"] = [r.row() for r in self.records]
            doc["records_dropped"] = self._n_spans - len(self.records)
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1)

    def merge_file(self, path: str):
        """Fold a worker process's written profile into this one: chunk
        stages and span totals add directly; the worker's own pipeline
        stages (its per-process setup) land under a `workers_` prefix. This
        closes the `--workers process` observability hole — without it,
        per-chunk stage timing vanished across the process boundary and
        chunk_stage_totals_s came back empty."""
        if not self.enabled:
            return
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return
        with self._lock:
            for k, rec in doc.get("chunks", {}).items():
                dst = self.chunks.setdefault(int(k), {})
                for s, v in rec.items():
                    dst[s] = dst.get(s, 0.0) + v
            for k, v in doc.get("stages_s", {}).items():
                key = f"workers_{k}"
                self.stages[key] = self.stages.get(key, 0.0) + v
            for name, m in doc.get("spans", {}).items():
                dst = self._merged_spans.setdefault(
                    name, {"n": 0, "total_s": 0.0, "self_s": 0.0, "work": 0})
                for k in dst:
                    dst[k] += m.get(k, 0)

    def log_summary(self, log=print):
        if not self.enabled:
            return
        s = self.summary()
        top = sorted(s["chunk_stage_totals_s"].items(), key=lambda kv: -kv[1])
        parts = ", ".join(f"{k} {v:.2f}s" for k, v in top[:8])
        log(f"> Profile: wall {s['wall_s']}s; chunk stages: {parts}")
        top2 = sorted(s["stages_s"].items(), key=lambda kv: -kv[1])
        parts2 = ", ".join(f"{k} {v:.2f}s" for k, v in top2[:8])
        log(f"> Profile: pipeline stages: {parts2}")
        top3 = sorted(s["spans"].items(), key=lambda kv: -kv[1]["self_s"])
        parts3 = ", ".join(f"{k} {v['self_s']:.2f}s" for k, v in top3[:8])
        log(f"> Profile: spans by self time: {parts3}")


NULL = Profiler(enabled=False)
