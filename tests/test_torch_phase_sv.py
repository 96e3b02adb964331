"""SV phasing (`useSVsForPhasing` with `onlyUseSNPVCFEntries`), the
configuration of the benchmark cell `phase-ont.sv-rich`, on the CPU.

One seeded set from the benchmark's generator under that cell's
configuration and traffic mix, cut to a 30 kb contig at 20x of 2-6 kb
reads with three het SVs of 50-300 bp and the SV alleles' reference
context cut to 200 bp (so the SV pairs, ~500-700 symbols, still take
the banded seam). Its params file carries `sv_hmm()`, under which a
read's own SV allele outscores the other (under the generator's default
HMM every SV is called homozygous), without run lengths. The port's run_phase(device="cpu") must write the JAX
package's phased VCF, phaseset.bed and haplotagged BAM byte for byte
and phase every SV with its set; every SV pair it scored must carry the
plain reference's k-mer anchors (`portbench/reference/svscore.py`),
and a sample of them a total within the cell's `banded_total_gap`
limit of the reference's.
"""

import filecmp
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from margin_tpu_torch.io import bam as bamio
from margin_tpu_torch.io.vcf import mark_svs, parse_vcf
from margin_tpu_torch.ops import banded
from margin_tpu_torch.params import Params
from margin_tpu_torch.phase import variants as pvariants
from margin_tpu_torch.phase.driver import run_phase
from margin_tpu_torch.utils import profiling
from portbench import control, harness, truth
from portbench.reference import hmm, pairhmm, svscore
from portbench.traffic import synth

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "phase-ont.sv-rich"
EXPANSION = 200          # referenceExpansionForStructuralVariants here
SV_MIN = 50              # indelSizeForSVHandling of the configuration
# sv_phase_error's limit: sound 0, permuted banded totals 0.40 and 0.75
SV_PHASE_ERROR_LIMIT = 0.2


def sv_hmm() -> dict:
    """A pair-HMM (margin's type-3 JSON) under which a read's own SV allele
    outscores the other: identical bases 0.2275, transitions 0.0075,
    transversions 0.005, gaps 0.25 a base; gap extension 0.3. Under
    margin's default nucleotide HMM, which the benchmark's generator
    writes in place of the trained tables, a gap extends with 0.71 and a
    matched pair emits 0.15, so a read's total is higher against the
    shorter allele whichever it carries, and every SV is called
    homozygous."""
    em = np.full((4, 4), 0.005)
    np.fill_diagonal(em, 0.2275)
    for a, b in ((0, 2), (2, 0), (1, 3), (3, 1)):
        em[a, b] = 0.0075
    ext, sw = 0.3, 0.01
    return {"type": 3, "emissionsType": 0,
            "transitions": [0.97, 0.015, 0.015, 1 - ext - sw, ext, sw,
                            1 - ext - sw, sw, ext],
            "emissions": em.ravel().tolist() + [0.25] * 8}


def is_sv(v) -> bool:
    return max(len(v.ref), len(v.alt)) - 1 >= SV_MIN


def sv_phase_error(sites, variants, lo: int, hi: int):
    """(share of the phased true het SVs in [lo, hi) whose phase is the
    minority one of their phase set, a tie counting half; the share of
    the true het SVs in [lo, hi) left unphased), or None where [lo, hi)
    holds no SV. A set's majority counts all its phased true sites."""
    sets = {}
    n_sv = 0
    for v in variants:
        if not lo <= v.pos < hi:
            continue
        n_sv += is_sv(v)
        gt, ps = sites.get(v.pos, (".", "."))
        if gt not in ("0|1", "1|0"):
            continue
        alt_on = 2 if gt == "0|1" else 1
        sets.setdefault(ps, []).append((alt_on == v.hap, is_sv(v)))
    if not n_sv:
        return None
    wrong = 0.0
    phased = 0
    for s in sets.values():
        agree = sum(a for a, _ in s)
        for a, sv in s:
            if not sv:
                continue
            phased += 1
            mine = agree if a else len(s) - agree
            wrong += 1.0 if 2 * mine < len(s) else (
                0.5 if 2 * mine == len(s) else 0.0)
    return (wrong / phased if phased else 1.0), 1.0 - phased / n_sv


class AlterBandedOrder(control._Fault):
    """Every banded call returns its items' totals in a seeded permuted
    order: the SV alleles' supports go to other pairs, as a fault
    upstream of the seam or in its routing would send them."""
    module, attr = "margin_tpu_torch.ops.banded", "banded_posteriors_many"

    def wrap(self, real):
        def banded_posteriors_many(tables, items, expansion, threshold=0.01,
                                   use_lut=False, dynamic=False):
            res = real(tables, items, expansion, threshold, use_lut, dynamic)
            perm = np.random.default_rng(len(res)).permutation(len(res))
            return [(r[0], res[p][1]) for r, p in zip(res, perm)]
        return banded_posteriors_many


def _cell():
    cell = harness.load_cell(CELL)
    params = cell.config["params"]
    params["phase"]["referenceExpansionForStructuralVariants"] = EXPANSION
    cell.config.update(contig_len=30_000, region_len=30_000, coverage=20,
                       read_len=[2000, 6000], params=params)
    cell.traffic = dict(cell.traffic, sv_per_mb=100, sv_len=[50, 300],
                        sv_short_max=300)
    return cell


def _dataset(d):
    ds = synth.generate(d, "phase", _cell().spec(), 2 ** 31 + 21)
    with open(ds.params) as fh:
        doc = json.load(fh)
    doc["polish"]["hmmForwardStrandReadGivenReference"] = sv_hmm()
    doc["polish"]["useRunLengthEncoding"] = False
    with open(ds.params, "w") as fh:
        json.dump(doc, fh)
    return ds


def run_jax_phase(d):
    """Subprocess body: margin_tpu's run_phase on the set in `d`."""
    os.environ["MARGIN_TPU_PALLAS"] = "interpret"
    from margin_tpu.params import Params as JaxParams
    from margin_tpu.phase.driver import run_phase as jax_run_phase
    jax_run_phase(f"{d}/reads.bam", f"{d}/ref.fa", f"{d}/calls.vcf",
                  JaxParams.load(f"{d}/params.json"), f"{d}/jax",
                  use_lut=True, seed=0, log=lambda *a: None)


def run_faulted_phase(d):
    """Subprocess body: the port's run_phase on the set in `d` with the
    banded totals permuted among each call's items (the SVs' allele
    supports go to other pairs)."""
    torch.set_num_threads(1)
    ds = synth.Dataset("phase", "chr1", 0, f"{d}/reads.bam", f"{d}/ref.fa",
                       f"{d}/params.json", vcf=f"{d}/calls.vcf")
    _phase(ds, f"{d}/order", AlterBandedOrder())


class _Record:
    """Wraps the banded seam: every item with the total it got."""

    def __init__(self):
        self.items = []

    def __enter__(self):
        self.real = banded.banded_posteriors_many

        def wrapped(tables, items, expansion, threshold=0.01, use_lut=False,
                    dynamic=False):
            res = self.real(tables, items, expansion, threshold, use_lut,
                            dynamic)
            for it, (_rows, total) in zip(items, res):
                self.items.append((it, float(total), threshold, expansion))
            return res
        banded.banded_posteriors_many = wrapped
        return self

    def __exit__(self, *exc):
        banded.banded_posteriors_many = self.real


def _phase(ds, base, fault=None):
    prof = profiling.Profiler(enabled=True)
    if fault is not None:
        fault.install()
    try:
        with _Record() as rec:
            banded.ROUTES.reset()
            run_phase(ds.bam, ds.fasta, ds.vcf, Params.load(ds.params), base,
                      use_lut=True, seed=0, device="cpu", profiler=prof,
                      log=lambda *a: None)
    finally:
        if fault is not None:
            fault.uninstall()
    routes = (banded.ROUTES.pack_items, banded.ROUTES.host_items)
    return rec.items, prof.span_totals(), routes


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("phase_sv"))
    cell = _cell()
    ds = _dataset(d)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2")
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import jax; jax.config.update('jax_platforms', 'cpu')\n"
            "import test_torch_phase_sv as T\n"
            % (HERE, os.path.dirname(HERE)))
    procs = [subprocess.Popen([sys.executable, "-c", code + body % d],
                              env=env)
             for body in ("T.run_jax_phase(%r)\n",
                          "T.run_faulted_phase(%r)\n")]
    try:
        items, spans, routes = _phase(ds, f"{d}/torch")
    finally:
        assert [p.wait(timeout=300) for p in procs] == [0, 0]
    return d, cell, ds, items, spans, routes


def test_phased_vcf_bed_and_bam_byte_identical_to_margin_tpu(run):
    d = run[0]
    for ext in ("phased.vcf", "phaseset.bed"):
        assert filecmp.cmp(f"{d}/torch.{ext}", f"{d}/jax.{ext}",
                           shallow=False), ext

    def records(path):
        with bamio.BamReader(path) as r:
            return [rec.raw for rec in r]
    assert records(f"{d}/torch.haplotagged.bam") == \
        records(f"{d}/jax.haplotagged.bam")


def test_sv_pairs_take_the_seam_under_their_spans(run):
    _, _, ds, items, spans, (pack_items, host_items) = run
    sv = [it for it in items if it[2] > 1.0]
    assert sv and len(sv) == len(items)          # phase: totals only
    assert pack_items >= 1 and host_items >= 1
    assert pack_items + host_items == len(items)
    # the seam's items are the SV pairs the spans counted
    assert spans["phase.sv_score"]["work"] == len(items)
    assert spans["phase.sv_anchors"]["work"] == len(items)
    assert spans["phase.sv_anchors"]["n"] == spans["phase.sv_score"]["n"]
    assert spans["phase.sv_score"]["total_s"] >= \
        spans["phase.sv_anchors"]["total_s"]
    assert spans["banded.host_engine"]["work"] == host_items


def test_sv_pairs_match_the_plain_reference(run):
    """Every SV pair carries the reference's anchors, made from the pair
    alone; the totals of a seeded sample (the widest and the deepest
    bands among them) lie within the cell's banded_total_gap limit of
    the reference's float64 totals."""
    _, cell, ds, items, _, _ = run
    limit = harness.load_cell(CELL).limits["banded_total_gap"]
    with open(ds.params) as fh:
        tabs = hmm.tables_from_params(json.load(fh))
    tabs.repeat = None
    pairs, widths = [], []
    for it, total, _thr, expansion in items:
        want = svscore.kmer_anchors(it["x_sym"], it["y_sym"], expansion)
        got = [tuple(int(v) for v in a) for a in it["anchors"]]
        assert got == want
        band = pairhmm.build_band(want, len(it["x_sym"]), len(it["y_sym"]),
                                  expansion)
        widths.append(int(((band[:, 1] - band[:, 0]) // 2 + 1).max()))
        pairs.append({"x": it["x_sym"], "y": it["y_sym"],
                      "strand": it["strand"], "total": total})
    depths = [len(p["x"]) + len(p["y"]) for p in pairs]
    pick = set(np.random.default_rng(7).choice(len(pairs), 6,
                                               replace=False).tolist())
    pick |= set(np.argsort(widths)[-2:].tolist())
    pick |= set(np.argsort(depths)[-2:].tolist())
    assert max(widths[i] for i in pick) > 128     # a host-engine band
    sample = [pairs[i] for i in sorted(pick)]
    ref = svscore.totals(tabs, sample, items[0][3], True)
    gaps = [abs(p["total"] - r) / max(1.0, abs(r))
            for p, r in zip(sample, ref)]
    assert max(gaps) <= limit, max(gaps)


def test_the_configuration_leaves_small_indels_out_and_phases_svs(run):
    """Small indels are not primary, so they stay out of the read-
    partition HMM; margin phases them afterwards from the haplotagged
    reads, as it does every filtered variant. The SVs are primary and
    phased."""
    d, cell, ds, _, _, _ = run
    params = Params.load(ds.params)
    assert params.phase.onlyUseSNPVCFEntries and \
        params.phase.useSVsForPhasing
    entries = parse_vcf(ds.vcf, None, use_rle=False)
    mark_svs(entries, params.phase.indelSizeForSVHandling)
    primary, filtered = pvariants.get_vcf_entries_for_region(
        entries, ds.contig, 0, ds.length, params, random.Random(0))
    small_indels = [e for e in filtered if e.is_indel and not e.is_sv]
    assert small_indels and not any(e.is_indel and not e.is_sv
                                    for e in primary)
    assert [e.ref_pos for e in primary if e.is_sv] == \
        [v.pos + 1 for v in ds.variants if is_sv(v)]
    sites = truth.phased_sites(f"{d}/torch.phased.vcf")
    _, sv_unphased = sv_phase_error(sites, ds.variants, 0, ds.length)
    assert sv_unphased == 0.0
    indels = [v for v in ds.variants if v.kind != "snv" and not is_sv(v)]
    assert indels and all(sites[v.pos][0] in ("0|1", "1|0")
                          for v in indels)


def test_sv_phase_error_is_zero_sound_and_high_with_supports_moved(run):
    d, cell, ds, _, _, _ = run
    sites = truth.phased_sites(f"{d}/torch.phased.vcf")
    err, _ = sv_phase_error(sites, ds.variants, 0, ds.length)
    assert err == 0.0
    # the banded totals permuted among each call's items (the fixture's
    # second run): the SVs' allele supports go to other pairs
    bad, _ = sv_phase_error(truth.phased_sites(f"{d}/order.phased.vcf"),
                            ds.variants, 0, ds.length)
    assert bad > SV_PHASE_ERROR_LIMIT


def test_sv_phase_error_counts_svs_against_their_set():
    V = synth.Variant
    variants = [V(100, "A", "C", 1, "snv"), V(200, "A", "G", 1, "snv"),
                V(300, "A", "A" + "C" * 60, 1, "ins"),
                V(400, "A" * 61, "A", 2, "del"), V(500, "A", "T", 2, "snv")]
    sites = {100: ("1|0", "p"), 200: ("1|0", "p"), 300: ("0|1", "p"),
             400: ("0|1", "p"), 500: ("0|1", "q")}
    err, unphased = sv_phase_error(sites, variants, 0, 1000)
    assert err == 0.5 and unphased == 0.0      # the insertion is flipped
    assert sv_phase_error(sites, variants, 0, 250) is None
    err, unphased = sv_phase_error({}, variants, 0, 1000)
    assert err == 1.0 and unphased == 1.0


def test_the_cell_loads_its_configuration_and_traffic():
    cell = harness.load_cell(CELL)
    assert cell.kind == "phase" and cell.chips == 1
    phase = cell.config["params"]["phase"]
    assert phase["onlyUseSNPVCFEntries"] is True
    assert phase["useSVsForPhasing"] is True
    assert phase["referenceExpansionForStructuralVariants"] == 1024
    spec = cell.spec()
    assert spec["sv_per_mb"] == 30 and spec["sv_len"] == [50, 2000]
    assert spec["indel_fraction"] == 0.15
    assert spec["region_len"] == 400_000 and spec["contig_len"] == 1_200_000
    assert set(cell.required) == {"k1_total_gap", "banded_total_gap",
                                  "haplotag_error", "phase_error"}
    names = {m["name"] for m in cell.per_layer}
    assert {"phase.sv_score_s_per_mb", "phase.sv_anchors_s_per_mb",
            "phase.banded_host_engine_s_per_mb",
            "banded.host_item_share.phase", "k2_roofline.phase",
            "phase.bubble_scoring_s_per_mb", "device.idle_share.phase",
            "step_mfu.phase"} <= names
    assert [m["name"] for m in cell.end_to_end] == ["phase_kb_per_s",
                                                    "setup_s"]


def test_the_new_readers_read_their_spans_and_counters():
    spans = {name: {"n": 2, "total_s": 3.0, "self_s": 1.0, "work": 8}
             for name in ("phase.sv_score", "phase.sv_anchors",
                          "banded.host_engine")}
    run = harness.RunData(cell=None, kb=400.0, window_s=51.0,
                          profile={"spans": spans},
                          counters={"k2_items": 30, "k3_items": 0,
                                    "host_items": 10})
    for metric in ("phase.sv_score_s_per_mb", "phase.sv_anchors_s_per_mb",
                   "phase.banded_host_engine_s_per_mb"):
        read = harness._reader(metric)
        assert read(run) == pytest.approx(7.5)
        assert read(harness.RunData(cell=None, kb=400.0,
                                    window_s=51.0)) is None
    share = harness._reader("banded.host_item_share.phase")
    assert share(run) == pytest.approx(25.0)
    assert share(harness.RunData(cell=None, kb=400.0, window_s=51.0)) is None
    assert harness._reader("k2_roofline.phase")(run) is None   # no trace


def test_the_sv_helper_takes_the_long_pairs_in_order():
    """score_sv_pairs sends exactly the pairs either side of which is
    longer than the limit to the seam, totals only and in order, and
    hands the others back in order."""
    from margin_tpu_torch.phase.bubbles import score_sv_pairs
    rng = np.random.default_rng(5)
    lens = [(30, 40), (260, 250), (10, 300), (90, 80), (255, 10)]
    pairs = [(rng.integers(0, 4, a).astype(np.int8),
              rng.integers(0, 4, b).astype(np.int8)) for a, b in lens]
    strands = [0, 1, 0, 1, 0]
    owners = list("abcde")
    seen = []

    def fake(tables, items, expansion, threshold=0.01, use_lut=False,
             dynamic=False):
        seen.append((items, threshold, expansion))
        return [((None, None, None), -float(len(it["x_sym"])))
                for it in items]
    real = banded.banded_posteriors_many
    banded.banded_posteriors_many = fake
    try:
        out = score_sv_pairs(None, pairs, strands, [], owners, False, 250,
                             20, True)
        unchanged = score_sv_pairs(None, pairs, strands, [], owners, False,
                                   0, 20, True)
    finally:
        banded.banded_posteriors_many = real
    scored, kept, kept_strands, kept_reps, kept_owners = out
    assert scored == [("b", -260.0), ("c", -10.0), ("e", -255.0)]
    (items, threshold, expansion), = seen
    assert threshold == 2.0 and expansion == 20
    assert [it["strand"] for it in items] == [1, 0, 0]
    assert [len(p[0]) for p in kept] == [30, 90] and kept_strands == [0, 1]
    assert kept_reps == [] and kept_owners == ["a", "d"]
    assert unchanged == ([], pairs, strands, [], owners)
