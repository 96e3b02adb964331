"""The readers of the program's spans: seconds a Mb from a run's
profile, None where the span or the kb is missing; and every per-layer
metric of BENCHMARK.json has its reader."""

import json
import os

import pytest

from portbench import harness

SPAN_READERS = {
    "phase.write_bam_s_per_mb": "write_bam",
    "phase.k1_batch_s_per_mb": "k1.batch",
    "phase.k1_device_s_per_mb": "k1.device",
    "polish.banded_route_s_per_mb": "banded.route",
    "polish.banded_pack_s_per_mb": "banded.pack",
    "polish.banded_device_s_per_mb": "banded.device",
    "polish.banded_unpack_s_per_mb": "banded.unpack",
    "polish.poa_augment_s_per_mb": "poa.augment",
}


def _bench() -> dict:
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _run(kb: float, spans=None) -> harness.RunData:
    profile = {} if spans is None else {"spans": spans}
    return harness.RunData(cell=None, kb=kb, window_s=51.0, profile=profile)


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_a_span_reader_gives_seconds_a_mb(metric):
    read = harness._reader(metric)
    span = SPAN_READERS[metric]
    spans = {span: {"n": 4, "total_s": 3.0, "self_s": 1.0, "work": 12},
             "other": {"n": 1, "total_s": 100.0, "self_s": 100.0,
                       "work": 0}}
    assert read(_run(400.0, spans)) == pytest.approx(7.5)
    assert read(_run(400.0, {"other": spans["other"]})) is None
    assert read(_run(400.0)) is None          # a program with no spans
    assert read(_run(0.0, spans)) is None


def test_the_span_metrics_are_declared_as_read():
    per_layer = {m["name"]: m for m in _bench()["per_layer"]}
    for name in SPAN_READERS:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["unit"] == "s/Mb"
        assert m["better"] == "lower"
        cell = m["workloads"]
        assert cell == (["phase-ont.small-variants"]
                        if name.startswith("phase.")
                        else ["polish-ont.haploid"])


def test_every_per_layer_metric_names_a_reader_file():
    for m in _bench()["per_layer"]:
        path = os.path.join(harness.BENCH, "metrics", f"{m['name']}.py")
        assert os.path.isfile(path), path
        assert callable(harness._reader(m["name"]))
