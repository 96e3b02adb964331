"""Chunks across threads, worker processes and hosts in the port.

One seeded synthetic phase set (test_torch_phase's: a 20 kb contig at
~12x, two chunks, SV handling on). margin_tpu's run_phase with threads=2
(its Pallas kernels in interpret mode, in a subprocess with XLA's FMA
contraction off) is the reference for the port's `--workers process -t
2` (two CPU worker processes whose scoring the parent serves); the port's
`--hosts 2` (two processes of a gloo group on a free localhost port) must
equal its `-t 2`. All use the per-chunk RNG streams, so their phased VCF,
phaseset.bed, chunks CSV and haplotagged BAM records are byte-identical.
A `sitecustomize` on the runs' PYTHONPATH records, at exit, every module
of jax or margin_tpu each process of the worker run imported: none may.

Beside them: the cross-chunk banded funnel against direct calls, word
for word, and its failure reaching every waiter; a worker whose score
server cannot be reached exits non-zero; the launch counters under eight
threads; the gloo gather of byte strings of different lengths, and a
host that raises does not leave its peer waiting.
"""

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from margin_tpu_torch.io import bam as bamio
from margin_tpu_torch.ops import banded, cuda_banded, pairhmm
from margin_tpu_torch.params import StateMachineParams
from margin_tpu_torch.testing.synth import SynthConfig, write_dataset

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CONFIG = SynthConfig(contig_len=20_000, coverage=12.0, read_len=(2000, 6000),
                     n_snv=15, n_sv=2, sv_len=(100, 300), sv_min_gap=5000,
                     sv_expansion=200, seed=1)
FILES = ("chunks.csv", "phased.vcf", "phaseset.bed")

_JAX = """
import os
os.environ["MARGIN_TPU_PALLAS"] = "interpret"
import jax
jax.config.update("jax_platforms", "cpu")
from margin_tpu.params import Params
from margin_tpu.phase.driver import run_phase
d = %r
run_phase(f"{d}/reads.bam", f"{d}/ref.fa", f"{d}/calls.vcf",
          Params.load(f"{d}/params.json"), f"{d}/jax", use_lut=True,
          threads=2, log=lambda *a: None)
"""

_SITE = """
import atexit, os, sys

def _record():
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "margin_tpu"))
    path = os.path.join(os.environ["IMPORT_RECORD_DIR"], f"{os.getpid()}")
    with open(path, "w") as fh:
        fh.write(" ".join(sys.argv) + "\\n" + " ".join(bad))

if os.environ.get("IMPORT_RECORD_DIR"):
    atexit.register(_record)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def _phase(d, out, *flags, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "margin_tpu_torch", "phase", f"{d}/reads.bam",
         f"{d}/ref.fa", f"{d}/params.json", f"{d}/calls.vcf", "-o",
         f"{d}/{out}", "--device", "cpu", "-a", "CRITICAL"] + list(flags),
        env=env or _env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)


def _done(p, what):
    _, err = p.communicate(timeout=600)
    assert p.returncode == 0, (what, err.decode()[-3000:])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("workers"))
    write_dataset(d, CONFIG)
    site = f"{d}/site"
    record = f"{d}/imports"
    os.makedirs(site)
    os.makedirs(record)
    with open(f"{site}/sitecustomize.py", "w") as fh:
        fh.write(_SITE)
    procs = {"jax": subprocess.Popen(
        [sys.executable, "-c", _JAX % d], env=_env(), cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)}
    procs["workers"] = _phase(d, "workers", "-t", "2", "--workers",
                              "process", env=_env(
                                  PYTHONPATH=os.pathsep.join((site, ROOT)),
                                  IMPORT_RECORD_DIR=record))
    procs["threads"] = _phase(d, "threads", "-t", "2")
    port = _free_port()
    for h in range(2):
        procs[f"host {h}"] = _phase(
            d, "hosts", "--hosts", "2", "--host-id", str(h),
            "--coordinator", f"127.0.0.1:{port}")
    for what, p in procs.items():
        _done(p, what)
    return d, record


def _records(path):
    with bamio.BamReader(path) as r:
        return [rec.raw for rec in r]


@pytest.mark.parametrize("run,reference", [("workers", "jax"),
                                           ("hosts", "threads"),
                                           ("threads", "jax")])
def test_outputs_identical(runs, run, reference):
    d, _ = runs
    for f in FILES:
        with open(f"{d}/{run}.{f}", "rb") as a, \
                open(f"{d}/{reference}.{f}", "rb") as b:
            assert a.read() == b.read(), (run, f)
    got = _records(f"{d}/{run}.haplotagged.bam")
    assert got == _records(f"{d}/{reference}.haplotagged.bam")
    assert len(got) > 0
    with open(f"{d}/{run}.chunks.csv") as fh:
        assert len(fh.read().splitlines()) == 2


def test_worker_run_imports_no_jax(runs):
    """The parent and both workers recorded their modules: no jax, no
    margin_tpu."""
    _, record = runs
    found = {}
    for f in os.listdir(record):
        with open(os.path.join(record, f)) as fh:
            argv, bad = fh.read().split("\n")
        found[argv] = bad
    workers = [a for a in found if "--shard" in a]
    assert len(found) == 3 and len(workers) == 2, found
    assert all(bad == "" for bad in found.values()), found


def test_worker_without_its_server_exits_nonzero(runs, tmp_path):
    d, _ = runs
    p = _phase(d, "orphan", env=_env(
        MARGIN_TPU_SCORE_SERVER=str(tmp_path / "no.sock"),
        MARGIN_TPU_SCORE_AUTH="00"))
    _, err = p.communicate(timeout=300)
    assert p.returncode != 0
    assert b"Error" in err
    assert not os.path.exists(f"{d}/orphan.phased.vcf")


# --- the cross-chunk banded funnel ------------------------------------------

EXPANSION = 4


def _items(seed, n=5):
    """n anchored problems of 90-200 bases (one width bucket): y an
    erroneous copy of x, mixed strands."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        lx = int(rng.integers(90, 200))
        x = rng.integers(0, 4, lx).astype(np.int32)
        y = x.copy()
        flip = rng.random(lx) < 0.06
        y[flip] = (y[flip] + rng.integers(1, 4, int(flip.sum()))) % 4
        keep = rng.random(lx) > 0.03
        ypos = np.cumsum(keep) - 1
        xa = np.nonzero(keep)[0][::6][1:-1]
        items.append({"x_sym": x, "y_sym": y[keep],
                      "strand": int(rng.integers(0, 2)),
                      "anchors": [(int(a), int(ypos[a]), EXPANSION)
                                  for a in xa]})
    return items


def _fresh(items):
    return [{k: v for k, v in it.items() if k != "_geom"} for it in items]


def _tables():
    return pairhmm.PairHmmTables.from_params(
        StateMachineParams.default_nucleotide(), device="cpu")


def _three_threads(tables, calls, monkeypatch, solve):
    """Call banded_posteriors_many from three threads, the first one's
    first pack held (by `solve`, in _solve_pack's place) until the other
    two calls wait in the funnel's queue. Returns (results, errors)."""
    real = banded._solve_pack
    first = threading.Event()

    def held(*a, **k):
        if not first.is_set():
            first.set()
            deadline = time.time() + 30
            while len(banded._FB_FUNNEL._queue) < 2 \
                    and time.time() < deadline:
                time.sleep(0.005)
        return solve(real, *a, **k)
    monkeypatch.setattr(banded, "_solve_pack", held)
    got, errors = [None] * 3, [None] * 3

    def call(k):
        try:
            got[k] = banded.banded_posteriors_many(
                tables, _fresh(calls[k]), EXPANSION, use_lut=True)
        except Exception as e:
            errors[k] = e
    threads = [threading.Thread(target=call, args=(k,)) for k in range(3)]
    threads[0].start()
    assert first.wait(60)
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    return got, errors


def test_funnel_merges_calls_word_for_word(monkeypatch):
    tables = _tables()
    calls = [_items(s) for s in range(3)]
    monkeypatch.setenv("MARGIN_TPU_FB_FUNNEL", "0")
    banded.ROUTES.reset()
    want = [banded.banded_posteriors_many(tables, _fresh(c), EXPANSION,
                                          use_lut=True) for c in calls]
    direct_packs = banded.ROUTES.packs
    monkeypatch.setenv("MARGIN_TPU_FB_FUNNEL", "1")
    banded.ROUTES.reset()
    got, errors = _three_threads(tables, calls, monkeypatch,
                                 lambda real, *a, **k: real(*a, **k))
    assert errors == [None] * 3
    # the two queued calls shared their packs
    assert direct_packs == 3 and banded.ROUTES.packs == 2
    for g, w in zip(got, want):
        for (gp, gt), (wp, wt) in zip(g, w):
            assert gt == wt
            for a, b in zip(gp, wp):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        assert sum(len(p[0][0]) for p in g) > 0


def test_funnel_failure_reaches_every_waiter(monkeypatch):
    monkeypatch.setenv("MARGIN_TPU_FB_FUNNEL", "1")

    def broken(real, *a, **k):
        raise ValueError("pack failed")
    _, errors = _three_threads(_tables(), [_items(s) for s in range(3)],
                               monkeypatch, broken)
    assert all(isinstance(e, ValueError) for e in errors), errors
    assert banded._FB_FUNNEL._queue == [] and not banded._FB_FUNNEL._busy


# --- the launch counters ----------------------------------------------------

@pytest.mark.parametrize("make", [pairhmm._Counter,
                                  cuda_banded._WideCounter])
def test_launch_counter_counts_every_thread(make):
    """Eight threads (more than this machine's cores may be) bump one
    counter with the interpreter switching threads every microsecond: a
    lost update would show in the total."""
    counter = make()
    bump = ((lambda: counter.add("step"))
            if isinstance(counter, cuda_banded._WideCounter) else counter.add)

    def work():
        for _ in range(20_000):
            bump()
    threads = [threading.Thread(target=work) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert counter.launches == 8 * 20_000
    if isinstance(counter, cuda_banded._WideCounter):
        assert counter.designs["step"] == 8 * 20_000
    counter.reset()
    assert counter.launches == 0


# --- the gloo group -----------------------------------------------------------

_HOST = """
import sys
sys.path.insert(0, %r)
from margin_tpu_torch.parallel import multihost as mh

@mh.scoped
def run(rank, port, fail):
    mh.init(f"127.0.0.1:{port}", 2, rank)
    if fail and rank == 1:
        raise RuntimeError("host 1 failed")
    got = mh.allgather_bytes(b"" if rank == 0 else bytes(range(256)) * 4)
    objs = mh.allgather_objects({"rank": rank})
    mh.barrier("test")
    print([len(b) for b in got], got[1] == bytes(range(256)) * 4,
          [o["rank"] for o in objs], mh.loads_z(mh.dumps_z(got)) == got)

run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3] == "1")
"""


@pytest.mark.parametrize("fail", [False, True])
def test_gloo_group(fail):
    """Two hosts gather byte strings of 0 and 1024 bytes, and objects; a
    host that raises makes its peer fail too, well before the group's
    timeout."""
    port = _free_port()
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _HOST % ROOT, str(h), str(port),
         "1" if fail else "0"], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for h in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    if fail:
        assert all(p.returncode != 0 for p in procs), outs
        assert time.time() - t0 < 100
        return
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert out.split("\n")[0] == "[0, 1024] True [0, 1] True"
