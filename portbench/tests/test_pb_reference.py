"""The plain reference against the program's plain PyTorch twins on small
random inputs (the twins are the kernels' CPU stand-ins; the reference
shares no code with them)."""

import json

import numpy as np
import pytest
import torch

from portbench.reference import hmm, pairhmm as ref
from portbench.traffic import synth


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    from margin_tpu_torch.ops import pairhmm
    from margin_tpu_torch.params import Params
    doc = {"polish": {"hmmForwardStrandReadGivenReference":
                      synth.default_hmm_json()}}
    path = tmp_path_factory.mktemp("p") / "params.json"
    path.write_text(json.dumps(doc))
    p = Params.load(str(path))
    return (pairhmm.PairHmmTables.from_params(p.polish.sm_forward,
                                              p.polish.sm_reverse,
                                              device="cpu"),
            hmm.tables_from_params(doc))


def _mutated(rng, x, p=0.08):
    y = x.copy()
    m = rng.random(len(y)) < p
    y[m] = rng.integers(0, 4, int(m.sum()))
    return y


@pytest.mark.parametrize("lut", [True, False])
def test_dense_forward_against_the_twin(tables, lut):
    from margin_tpu_torch.ops import pairhmm
    prog_tabs, ref_tabs = tables
    rng = np.random.default_rng(5)
    pairs = []
    for i in range(6):
        x = rng.integers(0, 4, int(rng.integers(1, 90))).astype(np.uint8)
        pairs.append({"x": x, "y": _mutated(rng, x), "strand": i % 2,
                      "ragged_left": i == 2, "ragged_right": i in (3, 4)})
    batch = pairhmm.make_batch(
        [(p["x"], p["y"]) for p in pairs],
        strands=[p["strand"] for p in pairs],
        ragged_left=[p["ragged_left"] for p in pairs],
        ragged_right=[p["ragged_right"] for p in pairs], device="cpu")
    want = pairhmm.forward_total_plain(prog_tabs, batch, lut).double()
    got = ref.dense_forward_totals(ref_tabs, pairs, lut)
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-6, atol=1e-3)
    low = ref.dense_forward_totals(ref_tabs, pairs, lut, torch.bfloat16)
    assert np.abs(low - got).max() > 0.1


def test_banded_posteriors_against_the_twin(tables):
    from margin_tpu_torch.ops import banded
    prog_tabs, ref_tabs = tables
    rng = np.random.default_rng(6)
    items = []
    for i in range(4):
        x = rng.integers(0, 4, int(rng.integers(100, 300))).astype(np.uint8)
        y = _mutated(rng, x)
        items.append({"x_sym": x, "y_sym": y, "strand": i % 2,
                      "anchors": [(j, j) for j in range(8, len(x) - 8, 30)],
                      "ragged_left": i == 1, "ragged_right": i == 3})
    res = banded.banded_posteriors_many(prog_tabs, [dict(i) for i in items],
                                        20, threshold=0.01, use_lut=True)
    r = ref.banded_posteriors(ref_tabs, items, 20, True)
    for b, (rows, total) in enumerate(res):
        assert abs(total - r.totals[b]) < 1e-5 * abs(r.totals[b]) + 1e-3
        sel = r.selected(b, 0.01)
        for s in range(3):
            got = sel[s]
            want = rows[s]
            assert len(got) == len(want)
            if len(want):
                np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
                np.testing.assert_allclose(got[:, 0], want[:, 0] / 1e7,
                                           atol=5e-3)
