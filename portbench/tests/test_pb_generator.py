"""The frozen generator: seeds reproduce their files, the files hold what
the configuration and the traffic mix ask for, and a mix added as data
runs with no other file edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import harness
from portbench.tests import tiny
from portbench.traffic import synth

ROOT = harness.ROOT


def _digests(d):
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("cell", ["phase-ont.small-variants",
                                  "polish-ont.haploid"])
def test_a_seed_reproduces_its_files(tmp_path, cell):
    c = harness.load_cell(cell, tiny.overrides(cell))
    for sub in ("a", "b"):
        synth.generate(str(tmp_path / sub), c.kind, c.spec(), 2 ** 31 + 5)
    synth.generate(str(tmp_path / "c"), c.kind, c.spec(), 2 ** 31 + 6)
    assert _digests(tmp_path / "a") == _digests(tmp_path / "b")
    assert _digests(tmp_path / "a") != _digests(tmp_path / "c")


def test_phase_set_matches_its_mix(tmp_path):
    """The SV-rich mix, kept for the cell of that name (§7 of PERF.md):
    small variants and SVs at their densities."""
    cell = harness.load_cell("phase-ont.small-variants",
                             {"contig_len": 400_000, "coverage": 4})
    with open(os.path.join(ROOT, "portbench/traffic/sv-rich.json")) as fh:
        cell.traffic = json.load(fh)
    spec = cell.spec()
    ds = synth.generate(str(tmp_path), "phase", spec, 3)
    L = ds.length
    small = [v for v in ds.variants
             if max(len(v.ref), len(v.alt)) - 1 < 50]
    svs = [v for v in ds.variants if max(len(v.ref), len(v.alt)) - 1 >= 50]
    lo, hi = spec["het_every"]
    # one small het site every 1-2 kb (a few dropped beside the SVs)
    assert L / hi * 0.9 <= len(small) <= L / lo
    indels = [v for v in small if v.kind != "snv"]
    share = len(indels) / len(small)
    assert abs(share - spec["indel_fraction"]) < 0.03
    assert all(1 <= max(len(v.ref), len(v.alt)) - 1 <= 10 for v in indels)
    assert len(svs) == round(spec["sv_per_mb"] * L / 1e6)
    lens = np.array([max(len(v.ref), len(v.alt)) - 1 for v in svs])
    assert lens.min() >= 50 and lens.max() <= 2000
    assert abs((lens <= 500).mean() - spec["sv_short_fraction"]) < 0.1
    cov = ds.read_bases / L
    assert abs(cov - spec["coverage"]) / spec["coverage"] < 0.05
    assert set(ds.read_hap.values()) == {1, 2}


def test_polish_set_matches_its_mix(tmp_path):
    cell = harness.load_cell("polish-ont.haploid", {"contig_len": 60_000,
                                                     "coverage": 10})
    spec = cell.spec()
    ds = synth.generate(str(tmp_path), "polish", spec, 3)
    assert len(ds.variants) == len(ds.truth) // spec["draft_error_every"]
    kinds = [v.kind for v in ds.variants]
    assert abs(kinds.count("snv") / len(kinds) - 0.4) < 0.01
    assert ds.truth_segment(0, ds.length) == ds.truth
    cov = ds.read_bases / len(ds.truth)
    assert abs(cov - spec["coverage"]) / spec["coverage"] < 0.1
    with open(ds.params) as fh:
        pol = json.load(fh)["polish"]
    assert pol["chunkSize"] == spec["chunkSize"]
    assert "repeatCountSubstitutionMatrix" in pol


def test_a_mix_added_as_data_runs(tmp_path):
    """A traffic file and its workloads entry (and its limits), added to a
    copy of the benchmark, run through the harness with no edit to any
    other file."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(root / "portbench/traffic/snv-only.json", "w") as fh:
        json.dump({"kind": "phase", "why": "het SNVs only",
                   "het_every": [1000, 1500], "indel_fraction": 0.0,
                   "sv_per_mb": 0}, fh)
    with open(root / "portbench/limits/phase-ont.snv-only.json", "w") as fh:
        json.dump({"limits": {"k1_total_gap": 1e-4}, "required":
                   ["k1_total_gap"]}, fh)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "phase-ont.snv-only",
                               "config": "phase-ont-r941-hg002",
                               "traffic": "snv-only", "chips": 1,
                               "why": "het SNVs only"})
    for m in bench["end_to_end"]:
        if m["name"] == "phase_kb_per_s":
            m["workloads"].append("phase-ont.snv-only")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, json; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from portbench import harness\n"
        "cell = harness.load_cell('phase-ont.snv-only', json.loads("
        "sys.argv[3]))\n"
        "res = harness.run(cell, 9, 0.1, False, device='cpu')\n"
        "print(json.dumps({'attempted': res['attempted'], 'checks': "
        "res['checks'], 'metrics': res['metrics']}))\n")
    out = subprocess.run(
        [sys.executable, "-c", code, str(root), ROOT,
         json.dumps(tiny.PHASE)], capture_output=True, text=True,
        timeout=600, cwd=str(root))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["attempted"] >= 1
    assert "k1_total_gap" in res["checks"]
    assert res["metrics"]["phase_kb_per_s"]["value"] > 0
