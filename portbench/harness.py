"""One run of one benchmark cell: set-up, the measured window, the
comparison that decides `correct`, the metrics.

Everything that belongs to one cell is data found by name:
`BENCHMARK.json` names the cell's configuration and traffic mix,
`configs/<config>.json` holds the deployment (the program's settings and
the generator's sizes), `traffic/<traffic>.json` the mix (the
generator's variable part), `limits/<cell>.json` the limit of each
number compared, and `metrics/<metric>.py` the reader of each per-layer
metric. The generator, the reference and the comparison are this
folder's own; from the program the harness takes only its entry points
(`phase.driver.run_phase`, `polish.driver.run_polish`), its profiler, its
counters and, for the comparison, what its kernel launches returned.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "margin_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the cell, from data
# ---------------------------------------------------------------------------

def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    required: List[str]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.config["command"]

    def spec(self) -> dict:
        """The generator's parameters: the configuration's sizes and
        params, the traffic mix over them, the configuration's chunk
        geometry written into the params."""
        spec = json.loads(json.dumps(self.config))
        spec.update(self.traffic)
        pol = spec.setdefault("params", {}).setdefault("polish", {})
        for key in ("chunkSize", "chunkBoundary"):
            if key in self.config:
                pol[key] = self.config[key]
        return spec


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, overrides: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files; overrides (for
    tests at small sizes) replace configuration keys."""
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    wl = {w["name"]: w for w in bench["workloads"]}.get(name)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = _json(os.path.join(ROOT, cfg["file"]))
    config.update(overrides or {})
    traffic = _json(os.path.join(BENCH, "traffic", f"{wl['traffic']}.json"))
    limits = _json(os.path.join(BENCH, "limits", f"{name}.json"))
    return Cell(name, int(wl["chips"]), config, traffic, limits["limits"],
                limits["required"],
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


# ---------------------------------------------------------------------------
# what the program's launches returned: seeded samples for the comparison
# ---------------------------------------------------------------------------

class Reservoir:
    """At most k of a stream, each kept with equal chance (seeded)."""

    def __init__(self, rng, k: int):
        self.rng, self.k, self.n, self.items = rng, k, 0, []

    def offer(self, make):
        """Count one more of the stream; where it is kept, store make()."""
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = int(self.rng.integers(0, self.n))
        if j < self.k:
            self.items[j] = make()


class Sampler:
    """Wraps the program's K1 entry (`ops.pairhmm.forward_total`) and its
    banded seam (`ops.banded.banded_posteriors_many`) while installed:
    keeps a seeded sample of K1 launches and banded items with copies of
    what the program returned for them (its callers go on to edit the
    results in place), the deepest banded item, and with `record_all`
    every launch's shapes and every item with its count of posterior
    cells (for the rooflines). Each call also opens a span of its
    own."""

    def __init__(self, seed: int, record_all: bool, spans=None):
        rng = np.random.default_rng([seed, 17])
        self.lock = threading.Lock()
        self.k1 = Reservoir(rng, 4)
        self.shallow = Reservoir(rng, 12)
        self.deep = Reservoir(rng, 6)
        self.deepest = None
        self.record_all = record_all
        self.spans = spans
        self.k1_launches: List[tuple] = []
        self.k1_pairs = 0
        self.items: List[tuple] = []
        self.saved: List[tuple] = []

    def install(self):
        from margin_tpu_torch.ops import banded, pairhmm
        real_k1 = pairhmm.forward_total
        real_banded = banded.banded_posteriors_many
        span = self.spans or _no_span

        def forward_total(tables, batch, use_lut=False):
            with span("K1 launch"):
                out = real_k1(tables, batch, use_lut)
            with self.lock:
                B, Lx = batch.xs.shape
                self.k1_pairs += B
                self.k1.offer(lambda: (batch, out.clone(), bool(use_lut)))
                if self.record_all:
                    self.k1_launches.append(
                        (B, Lx, batch.ys.shape[1], batch.lxs, batch.lys,
                         batch.rep_x is not None
                         and tables.repeat is not None, bool(use_lut)))
            return out

        def banded_posteriors_many(tables, items, expansion, threshold=0.01,
                                   use_lut=False, dynamic=False):
            with span("banded seam"):
                res = real_banded(tables, items, expansion, threshold,
                                  use_lut, dynamic)
            key = (expansion, threshold, bool(use_lut), bool(dynamic),
                   tables.repeat is not None)
            with self.lock:
                for it, r in zip(items, res):
                    def rec(it=it, r=r):
                        return (_copy_item(it), (tuple(a.copy() for a in r[0]),
                                                 r[1]), key)
                    depth = len(it["x_sym"]) + len(it["y_sym"]) + 1
                    (self.deep if depth > 16384 else self.shallow).offer(rec)
                    if self.deepest is None or depth > self.deepest[0]:
                        self.deepest = (depth, rec())
                    if self.record_all:
                        self.items.append((len(it["x_sym"]), len(it["y_sym"]),
                                           _anchors(it),
                                           it.get("rep_x") is not None,
                                           sum(len(a) for a in r[0]), key))
            return res
        self.saved = [(pairhmm, "forward_total", real_k1),
                      (banded, "banded_posteriors_many", real_banded)]
        pairhmm.forward_total = forward_total
        banded.banded_posteriors_many = banded_posteriors_many

    def uninstall(self):
        for mod, attr, real in self.saved:
            setattr(mod, attr, real)
        self.saved = []

    def banded_sample(self) -> List[tuple]:
        out = list(self.shallow.items) + list(self.deep.items)
        if self.deepest is not None and not any(
                len(r[0]["x_sym"]) + len(r[0]["y_sym"]) + 1
                == self.deepest[0] for r in self.deep.items):
            out.append(self.deepest[1])
        return out


def _anchors(it: dict) -> np.ndarray:
    a = it.get("anchors")
    return np.array([] if a is None else a, dtype=np.int64)


def _copy_item(it: dict) -> dict:
    keys = ("x_sym", "y_sym", "anchors", "strand", "rep_x", "rep_y",
            "ragged_left", "ragged_right")
    out = {}
    for k in keys:
        v = it.get(k)
        out[k] = (np.array(v, copy=True) if isinstance(v, np.ndarray)
                  else list(v) if isinstance(v, list) else v)
    return out


class Spans:
    """Host spans of every thread, (start, end, name) on the
    perf_counter clock; each also opens a profiler span of its name."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: List[tuple] = []

    @contextmanager
    def __call__(self, name: str):
        from torch.profiler import record_function
        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            with self.lock:
                self.spans.append((t0, time.perf_counter(), name))


@contextmanager
def _no_span(name: str):
    yield


def span_profiler(spans: Spans):
    """The program's Profiler, each stage and chunk stage also a span of
    the same name (for the trace's idle-gap labels)."""
    from margin_tpu_torch.utils import profiling

    class SpanProfiler(profiling.Profiler):
        @contextmanager
        def stage(self, name):
            with spans(name), super().stage(name):
                yield

        @contextmanager
        def chunk_stage(self, chunk_idx, name):
            with spans(name), super().chunk_stage(chunk_idx, name):
                yield
    return SpanProfiler(enabled=True)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

@dataclass
class Call:
    region: tuple
    out_base: str
    seconds: float
    error: Optional[str] = None


@dataclass
class RunData:
    """What the per-layer readers read (metrics/<name>.py)."""
    cell: Cell
    kb: float
    window_s: float
    profile: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    trace: object = None
    work: dict = field(default_factory=dict)


class Program:
    """The system under test, as a user's `margin phase` / `margin
    polish` reaches it under the CLI."""

    def __init__(self, cell: Cell, ds, device: str):
        self.cell, self.ds, self.device = cell, ds, device

    def call(self, region, out_base: str, profiler=None):
        from margin_tpu_torch.params import Params
        from margin_tpu_torch.utils import profiling
        a, b = region
        reg = f"{self.ds.contig}:{a + 1}-{b}"      # 1-based, inclusive
        params = Params.load(self.ds.params)
        kw = dict(region=reg, seed=0, use_lut=bool(self.cell.config[
            "use_lut"]), profiler=profiler or profiling.NULL,
            threads=int(self.cell.config["threads"]), device=self.device,
            log=lambda *a, **k: None)
        if self.cell.kind == "phase":
            from margin_tpu_torch.phase.driver import run_phase
            run_phase(self.ds.bam, self.ds.fasta, self.ds.vcf, params,
                      out_base, **kw)
        else:
            from margin_tpu_torch.polish.driver import run_polish
            run_polish(self.ds.bam, self.ds.fasta, params, out_base, **kw)


def regions(cell: Cell, length: int):
    rl = int(cell.config["region_len"])
    return [(a, min(a + rl, length)) for a in range(0, length, rl)]


def warmup_region(cell: Cell, ds):
    """The smallest input that reaches every kernel and engine of the
    cell: phase, 20 kb around the first SV (else the first het site);
    polish, one chunk mid-draft."""
    if cell.kind == "phase":
        svs = [v for v in ds.variants if max(len(v.ref), len(v.alt)) > 50]
        p = (svs or ds.variants)[0].pos
        a = max(0, p - 10_000)
        return a, min(ds.length, a + 20_000)
    a = ds.length // 2
    return a, min(ds.length, a + int(cell.config.get(
        "chunkSize", cell.config["region_len"])))


def build_program(kernels: bool = True) -> float:
    """Build (first run in a checkout) or load every kernel (on a card)
    and host engine from the program's fixed build directory inside the
    checkout; returns the seconds it took."""
    from margin_tpu_torch import _ext
    t = time.perf_counter()
    names = list(_ext.NATIVE_ENGINES)
    if kernels:
        names += list(_ext.KERNEL_SOURCES)
    bad = {k: v for k, v in _ext.build(names).items() if v}
    if bad:
        raise RuntimeError(f"the program did not build: {bad}")
    for name in _ext.KERNEL_SOURCES if kernels else ():
        _ext.kernel_lib(name)
    for name in _ext.NATIVE_ENGINES:
        if _ext.native_lib(name) is None:
            raise RuntimeError(f"host engine {name} did not load: "
                               f"{_ext.LOAD_ERRORS.get(name)}")
    return time.perf_counter() - t


def reset_counters():
    from margin_tpu_torch.ops import banded, pairhmm
    from margin_tpu_torch.parallel.executor import DEVICE_STATS
    banded.ROUTES.reset()
    DEVICE_STATS.reset()
    pairhmm.FORWARD_TOTAL.reset()


def read_counters() -> dict:
    from margin_tpu_torch.ops import banded, pairhmm
    from margin_tpu_torch.parallel.executor import DEVICE_STATS
    r = banded.ROUTES
    return {"device_stats": DEVICE_STATS.snapshot(),
            "k1_launches": pairhmm.FORWARD_TOTAL.launches,
            "k2_items": r.pack_items, "k3_items": r.seg_items,
            "host_items": r.host_items}


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        fault=None, after=None) -> dict:
    """One run of the cell; returns the result line's object (and, under
    "_readings", every number the comparison read). fault: an object
    whose install() breaks the program under the harness for the window;
    after(ds, sampler): more readings, returned under "_after"."""
    import torch
    from portbench import check
    from portbench.traffic import synth
    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device == "cuda"
    build_s = build_program(kernels=on_card)
    work = tempfile.mkdtemp(prefix=f"portbench-{cell.name}-")
    try:
        t = time.perf_counter()
        ds = synth.generate(os.path.join(work, "data"), cell.kind,
                            cell.spec(), seed)
        gen_s = time.perf_counter() - t
        prog = Program(cell, ds, device)
        t = time.perf_counter()
        prog.call(warmup_region(cell, ds), os.path.join(work, "warmup"))
        log(f"set-up: build {build_s:.2f} s, inputs {gen_s:.2f} s "
            f"({ds.n_reads} reads, {ds.read_bases} bases), warm-up "
            f"{time.perf_counter() - t:.2f} s")
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if fault is not None:
            fault.install()
        spans = Spans() if trace else None
        span = spans or _no_span
        sampler = Sampler(seed, record_all=trace, spans=spans)
        sampler.install()
        reset_counters()
        profiler = span_profiler(spans) if trace else None
        regs = regions(cell, ds.length)
        calls: List[Call] = []
        prof_ctx = _profile(trace and on_card)
        setup_s = time.perf_counter() - t_start
        with prof_ctx as prof:
            with span("portbench.window"):
                t0 = time.perf_counter()
                i = 0
                while True:
                    reg = regs[i % len(regs)]
                    base = os.path.join(work, f"call{i}")
                    c0 = time.perf_counter()
                    call = Call(reg, base, 0.0)
                    try:
                        with span("entry"):
                            prog.call(reg, base, profiler)
                    except Exception:       # a call that never answers
                        call.error = traceback.format_exc()
                        log(call.error)
                    if on_card:
                        torch.cuda.synchronize()
                    call.seconds = time.perf_counter() - c0
                    calls.append(call)
                    i += 1
                    if time.perf_counter() - t0 >= seconds:
                        break
                window_s = time.perf_counter() - t0
        sampler.uninstall()
        if fault is not None:
            fault.uninstall()
        log(f"window: {window_s:.2f} s, calls " + ", ".join(
            f"{c.region[0]}-{c.region[1]} {c.seconds:.2f} s" for c in calls))
        counters = read_counters()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        done = [c for c in calls if c.error is None]
        kb = sum(c.region[1] - c.region[0] for c in done) / 1000.0
        data = RunData(cell, kb, window_s,
                       profile=profiler.summary() if profiler else {},
                       counters=counters)
        if trace and on_card:
            from portbench import trace as tr
            path = os.path.join(work, "trace.json")
            prof.export_chrome_trace(path)
            data.trace = tr.summarize(path, "portbench.window", spans.spans,
                                      t0)
            os.remove(path)
        if trace:
            data.work = check.launch_work(sampler, cell)
        if on_card:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        readings = check.compare(cell, ds, calls, sampler, seed, device)
        log(f"comparison: {time.perf_counter() - t:.2f} s")
        checks = {k: {"value": readings[k], "limit": cell.limits[k]}
                  for k in cell.limits if k in readings}
        correct = (not any(c.error for c in calls)
                   and all(v["value"] <= v["limit"] for v in checks.values())
                   and all(k in readings for k in cell.required))
        metrics = _metrics(cell, data, trace, setup_s)
        dev = {"platform": "gpu" if on_card else "cpu",
               "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
               "count": cell.chips, "memory_peak_bytes": int(peak)}
        result = {"correct": bool(correct), "attempted": len(calls),
                  "failed": sum(c.error is not None for c in calls),
                  "metrics": metrics, "device": dev}
        if trace:
            ts = data.trace
            dev["busy_s"] = ts.busy_s if ts is not None else 0.0
            dev["window_s"] = window_s
            if ts is not None:
                result["breakdown"] = {"device_ops": ts.device_ops,
                                       "idle_gaps": ts.idle_gaps}
        result["checks"] = checks
        result["_readings"] = readings
        if after is not None:
            result["_after"] = after(ds, sampler)
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


@contextmanager
def _profile(on: bool):
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def _reader(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metrics(cell: Cell, data: RunData, trace: bool, setup_s: float) -> dict:
    out = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                out["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"].endswith("_kb_per_s"):
                out[m["name"]] = {"value": data.kb / data.window_s,
                                  "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        v = _reader(m["name"])(data)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the
    JAX package, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})
