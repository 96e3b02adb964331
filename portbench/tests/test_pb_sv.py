"""The cell `phase-ont.sv-rich` at a test size on the CPU: its readers,
its control and planted faults, the SV pair sample of `svcheck.py`, and
the plain reference of SV allele support (`reference/svscore.py`) against
the program's k-mer anchors."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import check, control, harness, svcheck
from portbench.reference import svscore
from portbench.tests import tiny

torch.set_num_threads(1)

CELL = "phase-ont.sv-rich"


def _tiny():
    """The cell at a test size: one region the whole contig, so that the
    window's one call holds its SV, SVs of 50-300 bp with 200 bp of
    reference context (the plain twins take the SV pairs here)."""
    cell = harness.load_cell(CELL, dict(tiny.overrides(CELL),
                                        region_len=tiny.PHASE["contig_len"]))
    cell.config["params"]["phase"][
        "referenceExpansionForStructuralVariants"] = 200
    cell.traffic = dict(cell.traffic, sv_len=[50, 300], sv_short_max=300)
    return cell


SV_SPAN_READERS = {
    "phase.sv_score_s_per_mb": "phase.sv_score",
    "phase.sv_anchors_s_per_mb": "phase.sv_anchors",
    "phase.banded_host_engine_s_per_mb": "banded.host_engine",
}
SMALL = "phase-ont.small-variants"
POLISH = "polish-ont.haploid"
# every program_span metric and the cells it is read in
SPAN_CELLS = {
    "phase.readextract_s_per_mb": [SMALL, CELL],
    "phase.bubble_scoring_s_per_mb": [SMALL, CELL],
    "phase.rphmm_s_per_mb": [SMALL, CELL],
    "phase.write_bam_s_per_mb": [SMALL],
    "phase.k1_batch_s_per_mb": [SMALL],
    "phase.k1_device_s_per_mb": [SMALL],
    "phase.sv_score_s_per_mb": [CELL],
    "phase.sv_anchors_s_per_mb": [CELL],
    "phase.banded_host_engine_s_per_mb": [CELL],
    "polish.realign_s_per_mb": [POLISH],
    "polish.repeat_counts_s_per_mb": [POLISH],
    "polish.banded_route_s_per_mb": [POLISH],
    "polish.banded_pack_s_per_mb": [POLISH],
    "polish.banded_device_s_per_mb": [POLISH],
    "polish.banded_unpack_s_per_mb": [POLISH],
    "polish.poa_augment_s_per_mb": [POLISH],
    "polish.poa_materialise_s_per_mb": [POLISH],
}


def _bench() -> dict:
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _run(kb: float, spans=None, counters=None) -> harness.RunData:
    profile = {} if spans is None else {"spans": spans}
    return harness.RunData(cell=None, kb=kb, window_s=51.0, profile=profile,
                           counters=counters or {})


@pytest.mark.parametrize("metric", sorted(SV_SPAN_READERS))
def test_an_sv_span_reader_gives_seconds_a_mb(metric):
    read = harness._reader(metric)
    span = SV_SPAN_READERS[metric]
    spans = {span: {"n": 4, "total_s": 3.0, "self_s": 1.0, "work": 12},
             "other": {"n": 1, "total_s": 100.0, "self_s": 100.0,
                       "work": 0}}
    assert read(_run(400.0, spans)) == pytest.approx(7.5)
    assert read(_run(400.0, {"other": spans["other"]})) is None
    assert read(_run(400.0)) is None          # a program with no spans
    assert read(_run(0.0, spans)) is None


def test_the_span_metrics_are_declared_for_their_cells():
    per_layer = {m["name"]: m for m in _bench()["per_layer"]}
    spans = {n for n, m in per_layer.items()
             if m["source"] == "program_span"}
    assert spans == set(SPAN_CELLS)
    for name, cells in SPAN_CELLS.items():
        m = per_layer[name]
        assert m["unit"] == "s/Mb" and m["better"] == "lower"
        assert m["workloads"] == cells, name


def test_the_host_item_share_reads_the_route_counters():
    read = harness._reader("banded.host_item_share.phase")
    assert read(_run(400.0, counters={"k2_items": 3, "k3_items": 1,
                                      "host_items": 4})) == 50.0
    assert read(_run(400.0, counters={"k2_items": 0, "k3_items": 0,
                                      "host_items": 0})) is None
    assert read(_run(400.0)) is None


def test_the_cell_reports_its_metrics():
    cell = harness.load_cell(CELL)
    assert [m["name"] for m in cell.end_to_end] == ["phase_kb_per_s",
                                                    "setup_s"]
    for m in cell.per_layer:
        assert m["moves"] == "phase_kb_per_s"
    assert {m["name"] for m in cell.per_layer} >= set(SV_SPAN_READERS) | {
        "banded.host_item_share.phase", "k2_roofline.phase"}


def test_control_fails_and_the_program_passes():
    def control_readings(ds, sampler):
        return check.kernel_readings(ds, sampler, 0, "cpu",
                                     against=torch.bfloat16)
    res = harness.run(_tiny(), 31, 0.1, False, device="cpu",
                      after=control_readings)
    limits = harness.load_cell(CELL).limits
    program, ctrl = res["_readings"], res["_after"]
    kernel = [k for k in ctrl if k in limits]
    assert "banded_total_gap" in kernel
    assert all(ctrl[k] > limits[k] for k in kernel), ctrl
    assert all(program[k] <= limits[k] for k in kernel), program


@pytest.mark.parametrize("fault,check_name", [
    ("banded", "banded_total_gap"), ("k1", "k1_total_gap")])
def test_an_altered_answer_fails_its_check(fault, check_name):
    res = harness.run(_tiny(), 32, 0.1, False, device="cpu",
                      fault=control.FAULTS[fault]())
    c = res["checks"][check_name]
    assert res["correct"] is False and c["value"] > c["limit"]


def test_svcheck_holds_the_sampled_pairs_to_the_reference():
    (line,) = svcheck.readings(_tiny(), [33], 0.1, 12, "cpu")
    pairs = line["sv_pairs"]
    assert 0 < pairs["n"] <= 12 and pairs["seen"] >= pairs["n"]
    assert pairs["anchor_mismatches"] == 0
    assert pairs["total_gap"] <= harness.load_cell(CELL).limits[
        "banded_total_gap"]
    assert sum(r["n"] for r in pairs["routes"].values()) == pairs["n"]
    assert "banded_total_gap" in line["program"]


def _pair(rng, n, kind):
    x = rng.integers(0, 4, n)
    if kind == "same":
        y = x.copy()
    elif kind == "ins":
        y = np.concatenate([x[:n // 2], rng.integers(0, 4, 150),
                            x[n // 2:]])
    elif kind == "del":
        y = np.concatenate([x[:n // 3], x[n // 3 + 200:]])
    else:
        y = rng.integers(0, 4, n)
    flip = rng.random(len(y)) < 0.06
    y = y.copy()
    y[flip] = rng.integers(0, 5, int(flip.sum()))     # N (4) now and then
    return x.astype(np.int8), y.astype(np.int8)


@pytest.mark.parametrize("kind", ["same", "ins", "del", "random"])
def test_the_reference_anchors_equal_the_programs(kind):
    from margin_tpu_torch.polish.kmers import get_kmer_alignment_anchors
    rng = np.random.default_rng(len(kind))
    for n in (19, 20, 300, 1200):
        x, y = _pair(rng, n, kind)
        want = [tuple(int(v) for v in a)
                for a in get_kmer_alignment_anchors(x, y, 20)]
        assert svscore.kmer_anchors(x, y, 20) == want
    # repeats: a k-mer of x seen again counts at its first start
    x = np.tile(rng.integers(0, 4, 25), 8).astype(np.int8)
    y = x[30:170].copy()
    assert svscore.kmer_anchors(x, y, 7) == [
        tuple(int(v) for v in a) for a in get_kmer_alignment_anchors(x, y, 7)]


def test_the_sv_reference_loads_nothing_of_the_program():
    import subprocess
    import sys
    code = ("import sys, json; sys.path.insert(0, sys.argv[1])\n"
            "import portbench.reference.svscore\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in "
            "sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code, harness.ROOT],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "margin_tpu",
                       "margin_tpu_torch"}, tops
