"""The program's span model (`margin_tpu_torch/utils/profiling.py`):
nesting, parents and self time across threads, spans opened below the
drivers landing in the stage open on their thread, nothing recorded (and
no `record_function` entered) with the profiler off, the spans in a
`torch.profiler` trace, worker profiles folded in, the stage and chunk
keys the earlier profiler gave, and the seam spans a small phase run and
a small polish run reach (the datasets of `test_torch_phase.py` and
`test_torch_polish.py`)."""

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict

import numpy as np
import pytest
import torch

from margin_tpu_torch.ops import banded, pairhmm
from margin_tpu_torch.params import Params, StateMachineParams
from margin_tpu_torch.parallel import executor
from margin_tpu_torch.utils import profiling

torch.set_num_threads(1)

BANDED_SPANS = ("banded.route", "banded.pack", "banded.device",
                "banded.unpack")
SEAM_SPANS = BANDED_SPANS + ("k1.batch", "k1.device", "poa.items",
                             "poa.augment")


def _items(seed=3, n=3):
    """n anchored problems of 90-200 bases, y an erroneous copy of x."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lx = int(rng.integers(90, 200))
        x = rng.integers(0, 4, lx).astype(np.int32)
        keep = rng.random(lx) > 0.03
        y = x[keep].copy()
        ypos = np.cumsum(keep) - 1
        xa = np.nonzero(keep)[0][::6][1:-1]
        out.append({"x_sym": x, "y_sym": y, "strand": int(rng.integers(2)),
                    "anchors": [(int(a), int(ypos[a]), 4) for a in xa]})
    return out


def _tables():
    return pairhmm.PairHmmTables.from_params(
        StateMachineParams.default_nucleotide(), device="cpu")


def _by_name(prof):
    out: Dict[str, list] = {}
    for i, r in enumerate(prof.records):
        out.setdefault(r.name, []).append((i, r))
    return out


def _check_nesting(prof):
    """Every record closed, on its parent's thread and inside its parent's
    interval."""
    for r in prof.records:
        assert r.end_ns is not None and r.end_ns >= r.start_ns
        if r.parent >= 0:
            p = prof.records[r.parent]
            assert p.thread == r.thread
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
            assert r.end_ns - r.start_ns <= p.end_ns - p.start_ns


def test_nesting_parents_and_self_time_across_two_threads():
    prof = profiling.Profiler(enabled=True)
    gate = threading.Barrier(2)

    def chunk(ci):
        with prof.chunk_stage(ci, "realign"):
            gate.wait()
            with profiling.span("banded.pack", work=3):
                time.sleep(0.01)
            with profiling.span("poa.augment", work=2):
                with profiling.span("inner"):
                    time.sleep(0.005)

    with prof.stage("chunks"):
        threads = [threading.Thread(target=chunk, args=(ci,))
                   for ci in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    _check_nesting(prof)
    names = _by_name(prof)
    assert len(names["realign"]) == 2
    assert len({r.thread for _, r in names["realign"]}) == 2
    for i, r in names["realign"]:
        # a pool thread's stage has no parent on another thread
        assert r.parent == -1 and r.chunk in (0, 1)
        kids = [k for k in prof.records if k.parent == i]
        assert [k.name for k in kids] == ["banded.pack", "poa.augment"]
        assert all(k.chunk == r.chunk for k in kids)
    (_, stage), = names["chunks"]
    assert stage.chunk is None and stage.parent == -1
    spans = prof.summary()["spans"]
    assert spans["banded.pack"]["n"] == 2 and spans["banded.pack"]["work"] == 6
    assert spans["poa.augment"]["work"] == 4
    for name in ("realign", "poa.augment"):
        s = spans[name]
        child = ("banded.pack", "poa.augment") if name == "realign" \
            else ("inner",)
        assert s["self_s"] == pytest.approx(
            s["total_s"] - sum(spans[c]["total_s"] for c in child),
            abs=5e-6)
    assert spans["inner"]["self_s"] == spans["inner"]["total_s"]
    assert spans["chunks"]["self_s"] == spans["chunks"]["total_s"]


def test_many_threads_lose_no_span():
    """More threads than cores, each opening nested spans, with a short
    switch interval: every record is closed, its parent is on its own
    thread, and the totals count every span."""
    import sys
    prof = profiling.Profiler(enabled=True)
    n_threads, n_iter = 3 * (os.cpu_count() or 4), 200

    def chunk(ci):
        for _ in range(n_iter):
            with prof.chunk_stage(ci, "realign"):
                with profiling.span("banded.route", 1):
                    with profiling.span("inner"):
                        pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=chunk, args=(ci,))
                   for ci in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    _check_nesting(prof)
    for r in prof.records:
        if r.parent >= 0:
            assert prof.records[r.parent].chunk == r.chunk
    spans = prof.summary()["spans"]
    for name in ("realign", "banded.route", "inner"):
        assert spans[name]["n"] == n_threads * n_iter
    assert spans["banded.route"]["work"] == n_threads * n_iter
    assert prof.summary()["n_chunks"] == n_threads


def test_a_span_in_ops_code_lands_in_its_chunk_stage():
    prof = profiling.Profiler(enabled=True)
    with prof.chunk_stage(7, "realign"):
        res = banded.banded_posteriors_many(_tables(), _items(), 4,
                                            use_lut=True)
    assert len(res) == 3
    _check_nesting(prof)
    names = _by_name(prof)
    (root, _), = names["realign"]
    for name in BANDED_SPANS:
        assert names[name], name
        for _, r in names[name]:
            assert r.chunk == 7 and r.parent == root
    spans = prof.summary()["spans"]
    assert spans["banded.route"]["work"] == 3
    assert spans["banded.pack"]["work"] == spans["banded.unpack"]["work"] \
        == 3


def test_a_span_with_no_profiler_records_nothing(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "record_function", Counting)
    with profiling.span("k1.batch", 5):
        pass
    with profiling.NULL.chunk_stage(0, "realign"), \
            profiling.NULL.stage("chunks"):
        banded.banded_posteriors_many(_tables(), _items(n=2), 4,
                                      use_lut=True)
        with profiling.span("poa.augment"):
            pass
    off = profiling.Profiler(enabled=False)
    with off.stage("write_bam"):
        with profiling.span("write_bam.python"):
            pass
    assert entered == []
    assert profiling.NULL.records == [] and off.records == []
    assert profiling.NULL.summary()["spans"] == {}
    # the same calls under an enabled profiler enter it once a span
    on = profiling.Profiler(enabled=True)
    with on.stage("write_bam"):
        with profiling.span("write_bam.python"):
            pass
    assert entered == ["write_bam", "write_bam.python"]


def test_spans_are_user_annotations_in_a_torch_profiler_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    prof = profiling.Profiler(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        with prof.chunk_stage(2, "realign"):
            banded.banded_posteriors_many(_tables(), _items(n=2), 4,
                                          use_lut=True)
    path = str(tmp_path / "trace.json")
    tp.export_chrome_trace(path)
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    stage = [e for e in events if e["name"] == "realign"]
    assert len(stage) == 1
    a0, a1 = stage[0]["ts"], stage[0]["ts"] + stage[0]["dur"]
    for name in BANDED_SPANS:
        got = [e for e in events if e["name"] == name]
        assert len(got) == len(_by_name(prof)[name]), name
        for e in got:
            assert e["tid"] == stage[0]["tid"]
            assert a0 <= e["ts"] and e["ts"] + e["dur"] <= a1 + 1e-3


def test_merge_file_folds_a_workers_spans(tmp_path):
    worker = profiling.Profiler(enabled=True)
    with worker.chunk_stage(3, "realign"):
        with profiling.span("banded.pack", 4):
            pass
    path = str(tmp_path / "w.profile.json")
    worker.write(path)
    with open(path) as fh:
        doc = json.load(fh)
    assert "counters" not in doc
    assert doc["record_fields"] == list(profiling.RECORD_FIELDS)
    assert [r[0] for r in doc["records"]] == ["realign", "banded.pack"]
    assert doc["records"][1][3] == 0 and doc["records"][1][4] == 3
    parent = profiling.Profiler(enabled=True)
    with parent.chunk_stage(0, "realign"):
        with profiling.span("banded.pack", 1):
            pass
    parent.merge_file(path)
    parent.merge_file(str(tmp_path / "missing.json"))
    s = parent.summary()
    assert s["spans"]["banded.pack"]["n"] == 2
    assert s["spans"]["banded.pack"]["work"] == 5
    assert s["spans"]["realign"]["n"] == 2
    own = sum(r.end_ns - r.start_ns for r in parent.records
              if r.name == "realign") / 1e9
    assert s["spans"]["realign"]["total_s"] == pytest.approx(
        doc["spans"]["realign"]["total_s"] + own, abs=2e-6)
    assert s["n_chunks"] == 2 and "counters" not in s
    assert not hasattr(parent, "count")


class _Clock:
    """A clock that moves 1 ms a reading."""

    def __init__(self):
        self.ns = 10 ** 12

    def perf_counter_ns(self):
        self.ns += 1_000_000
        return self.ns

    def perf_counter(self):
        return self.perf_counter_ns() / 1e9

    def time(self):
        return self.ns / 1e9


def _drive(prof, clock, span):
    """A fixed sequence of stages and chunk stages, with spans below
    them; the clock read between them stands for work."""
    with prof.stage("chunker"):
        clock.perf_counter_ns()
    with prof.stage("chunks"):
        for ci in (0, 1, 2, 1):
            with prof.chunk_stage(ci, "readextract"):
                clock.perf_counter_ns()
            for _ in range(ci + 1):
                with prof.chunk_stage(ci, "realign"):
                    with span("poa.items"):
                        pass
                    with prof.chunk_stage(ci, "repeat_counts"):
                        clock.perf_counter_ns()
    with prof.stage("chunker"):
        pass
    with prof.stage("stitch"):
        clock.perf_counter_ns()


def test_stage_and_chunk_keys_equal_the_earlier_profilers(monkeypatch):
    """The JAX package's profiler, the port's before the span model, on
    the same sequence and an equal clock."""
    from margin_tpu.utils import profiling as jax_profiling
    clock = _Clock()
    monkeypatch.setattr(profiling, "time", clock)
    new = profiling.Profiler(enabled=True)
    _drive(new, clock, profiling.span)
    old_clock = _Clock()
    monkeypatch.setattr(jax_profiling, "time", old_clock)
    old = jax_profiling.Profiler(enabled=True)

    @contextmanager
    def ticks(name):
        # a span of the new profiler reads the clock as it opens and closes
        old_clock.perf_counter_ns()
        yield
        old_clock.perf_counter_ns()
    _drive(old, old_clock, ticks)
    keys = ("stages_s", "chunk_stage_totals_s", "n_chunks", "chunks")
    got, want = new.summary(), old.summary()
    assert want["n_chunks"] == 3 and want["stages_s"]["chunker"] > 0
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["spans"]["poa.items"]["n"] == 8


def test_records_past_the_cap_are_counted_not_kept(monkeypatch, tmp_path):
    """Past MAX_RECORDS a span is left out of the records but still adds
    to its totals; the written profile says how many were left out."""
    monkeypatch.setattr(profiling, "MAX_RECORDS", 4)
    prof = profiling.Profiler(enabled=True)
    with prof.chunk_stage(0, "realign"):
        for _ in range(6):
            with profiling.span("poa.items", work=2):
                with profiling.span("inner"):
                    pass
    assert [r.name for r in prof.records] == ["realign", "poa.items",
                                              "inner", "poa.items"]
    _check_nesting(prof)
    spans = prof.summary()["spans"]
    assert spans["poa.items"]["n"] == 6 and spans["poa.items"]["work"] == 12
    assert spans["inner"]["n"] == 6
    kids = spans["poa.items"]["total_s"]
    assert spans["realign"]["self_s"] == pytest.approx(
        spans["realign"]["total_s"] - kids, abs=5e-6)
    path = str(tmp_path / "p.json")
    prof.write(path)
    with open(path) as fh:
        doc = json.load(fh)
    assert len(doc["records"]) == 4 and doc["records_dropped"] == 9


def _blocking(service_cls, method):
    """A subclass whose `method` blocks its first caller until released;
    returns (instance, started, release)."""
    started, release = threading.Event(), threading.Event()

    class Blocking(service_cls):
        pass

    real = getattr(service_cls, method)

    def blocked(self, *a, **kw):
        if not started.is_set():
            started.set()
            release.wait(30)
        return real(self, *a, **kw)
    setattr(Blocking, method, blocked)
    return Blocking(), started, release


def _wait_queued(queue_of, n, timeout=30.0):
    t = time.time()
    while len(queue_of()) < n:
        assert time.time() - t < timeout
        time.sleep(0.005)


@pytest.mark.parametrize("seam", ["k1", "banded"])
def test_queue_spans_record_a_callers_wait_on_another_dispatcher(seam):
    """Two chunk threads on one funnel: the second waits while the first
    dispatches, and only that wait is its `<seam>.queue` span."""
    tables = _tables()
    prof = profiling.Profiler(enabled=True)
    if seam == "k1":
        svc, started, release = _blocking(executor._PairScoreService,
                                          "_run")
        rng = np.random.default_rng(0)
        pairs = [(rng.integers(0, 4, 40).astype(np.uint8),
                  rng.integers(0, 4, 44).astype(np.uint8))
                 for _ in range(3)]

        def call():
            return svc.score(tables, pairs, np.zeros(3, np.int32), None,
                             True, 64)
    else:
        svc, started, release = _blocking(banded._FbFunnel, "_dispatch")

        def call():
            return svc.solve(tables, _items(n=2), 4, 0.01, True, False)
    out = {}

    def chunk(ci):
        with prof.chunk_stage(ci, "scoring"):
            out[ci] = call()
    a = threading.Thread(target=chunk, args=(0,))
    a.start()
    assert started.wait(30)
    b = threading.Thread(target=chunk, args=(1,))
    b.start()
    _wait_queued(lambda: svc._queue, 1)
    release.set()
    a.join(60)
    b.join(60)
    assert set(out) == {0, 1}
    _check_nesting(prof)
    queued = _by_name(prof)[f"{seam}.queue"]
    assert len(queued) == 1 and queued[0][1].chunk == 1
    if seam == "k1":
        np.testing.assert_array_equal(out[0], out[1])
        assert prof.summary()["spans"]["k1.batch"]["work"] == 6


# -- a small phase run and a small polish run ------------------------------

def _reached(prof, names):
    spans = prof.summary()["spans"]
    return {n: spans[n]["n"] for n in names if n in spans}


@pytest.fixture(scope="module")
def phase_run(tmp_path_factory):
    from test_torch_phase import CONFIG
    from margin_tpu_torch.phase.driver import run_phase
    from margin_tpu_torch.testing.synth import write_dataset
    d = str(tmp_path_factory.mktemp("phase_spans"))
    ds = write_dataset(d, CONFIG)
    prof = profiling.Profiler(enabled=True)
    run_phase(ds.bam, ds.fasta, ds.vcf, Params.load(ds.params),
              f"{d}/out", use_lut=True, seed=0, device="cpu",
              profiler=prof, log=lambda *a: None)
    return d, ds, prof


def test_a_phase_run_reaches_the_k1_and_banded_spans(phase_run):
    _, _, prof = phase_run
    _check_nesting(prof)
    want = ("k1.batch", "k1.device", "write_bam") + BANDED_SPANS
    got = _reached(prof, want)
    assert set(got) == set(want) and min(got.values()) > 0, got
    spans = prof.summary()["spans"]
    assert spans["k1.batch"]["work"] == spans["k1.device"]["work"] > 0
    names = _by_name(prof)
    for name in ("k1.batch", "k1.device"):
        for _, r in names[name]:
            assert r.chunk is not None
    # the stages' keys stay as they were
    s = prof.summary()
    assert s["stages_s"]["write_bam"] == pytest.approx(
        spans["write_bam"]["total_s"], abs=1e-3)
    assert s["n_chunks"] == len(s["chunks"]) > 0


def test_the_bam_writer_logs_its_fallback_once(phase_run, monkeypatch):
    from margin_tpu_torch.io import bam as bamio
    from margin_tpu_torch.io import native
    from margin_tpu_torch.phase.driver import write_haplotagged_bam
    d, ds, _ = phase_run
    params = Params.load(ds.params)
    with bamio.BamReader(f"{d}/out.haplotagged.bam") as r:
        tagged = [(rec.name, rec.raw) for rec in r]
    names = {n for n, raw in tagged}
    hap1 = set(sorted(names)[::2])
    hap2 = names - hap1
    prof = profiling.Profiler(enabled=True)
    with prof.stage("write_bam"):
        want = write_haplotagged_bam(ds.bam, f"{d}/native.bam", None, hap1,
                                     hap2, params, log=None)

    def broken(*a, **kw):
        raise OSError("disk gone")
    monkeypatch.setattr(native, "write_haplotagged_native", broken)
    logged = []
    with prof.stage("write_bam"):
        got = write_haplotagged_bam(ds.bam, f"{d}/python.bam", None, hap1,
                                    hap2, params, log=logged.append)
    assert got == want
    assert len(logged) == 1 and "disk gone" in logged[0]
    spans = prof.summary()["spans"]
    assert spans["write_bam.python"]["n"] >= 1
    with bamio.BamReader(f"{d}/native.bam") as a, \
            bamio.BamReader(f"{d}/python.bam") as b:
        assert [r.raw for r in a] == [r.raw for r in b]


@pytest.fixture(scope="module")
def polish_run(tmp_path_factory):
    from test_torch_polish import CONFIG
    from margin_tpu_torch import cli
    from margin_tpu_torch.testing.synth import write_polish_dataset
    d = str(tmp_path_factory.mktemp("polish_spans"))
    ds = write_polish_dataset(d, CONFIG)
    assert cli.main(["polish", ds.bam, ds.draft, ds.params, "-o",
                     f"{d}/out", "--device", "cpu", "--profile",
                     "-a", "CRITICAL"]) == 0
    with open(f"{d}/out.profile.json") as fh:
        return json.load(fh)


def test_a_polish_run_reaches_the_poa_and_banded_spans(polish_run):
    doc = polish_run
    spans = doc["spans"]
    want = ("realign", "poa.items", "poa.augment") + BANDED_SPANS
    assert all(spans.get(n, {}).get("n", 0) > 0 for n in want), \
        {n: spans.get(n) for n in want}
    fields = doc["record_fields"]
    recs = [dict(zip(fields, r)) for r in doc["records"]]
    for r in recs:
        if r["parent"] >= 0:
            p = recs[r["parent"]]
            assert r["end_ns"] - r["start_ns"] <= p["end_ns"] - p["start_ns"]
            assert p["thread"] == r["thread"]
            if r["name"] in SEAM_SPANS:
                assert r["chunk"] == p["chunk"]
    # realign's direct children are the POA loops and the seam's spans
    kids = {recs[i]["name"] for i in range(len(recs))
            if recs[i]["parent"] >= 0
            and recs[recs[i]["parent"]]["name"] == "realign"}
    assert {"poa.items", "poa.augment", "banded.route", "banded.pack",
            "banded.device", "banded.unpack"} <= kids
    assert spans["poa.items"]["work"] == spans["poa.augment"]["work"]
    assert doc["chunk_stage_totals_s"]["realign"] == pytest.approx(
        spans["realign"]["total_s"], abs=2e-3)
    assert "counters" not in doc


def test_a_polish_run_builds_the_poa_nodes_once_a_chunk(polish_run):
    """The native graphs keep their columns through the POA iterations;
    only the bubble pass builds node objects, once a chunk."""
    doc = polish_run
    spans = doc["spans"]
    assert spans["poa.materialise"]["n"] == doc["n_chunks"] > 0
    fields = doc["record_fields"]
    recs = [dict(zip(fields, r)) for r in doc["records"]]
    parents = {recs[r["parent"]]["name"] for r in recs
               if r["name"] == "poa.materialise"}
    assert parents == {"polish_bubbles"}
