"""The frozen operation and byte counts and peaks against
`chip_smoke.py`'s on fixed shapes (the program's packs built on the
CPU)."""

import os
import sys

import numpy as np
import pytest

from portbench import harness, roofline
from portbench.reference import pairhmm as ref

sys.path.insert(0, harness.ROOT)
import chip_smoke  # noqa: E402


def test_peaks_and_cell_costs():
    assert roofline.PEAK_F32_FLOPS == chip_smoke.PEAK_F32_FLOPS
    assert roofline.PEAK_BYTES_PER_S == chip_smoke.PEAK_BYTES_PER_S
    for lut in (True, False):
        assert roofline.fwd_ops_per_cell(lut) == \
            chip_smoke.fwd_ops_per_cell(lut)
        assert roofline.bwd_ops_per_cell(lut) == \
            chip_smoke.bwd_ops_per_cell(lut)
    for ops, nb in ((1e9, 1e3), (1e3, 1e9)):
        assert roofline.bound_s(ops, nb) * 1e3 == pytest.approx(
            chip_smoke.bound_ms(ops, nb)[0], rel=1e-12)


def _rng_seq(rng, n):
    return rng.integers(0, 4, n).astype(np.uint8)


@pytest.mark.parametrize("rle", [False, True])
def test_k1_counts(rle):
    from margin_tpu_torch.ops import pairhmm
    from margin_tpu_torch.params import RepeatSubMatrix, StateMachineParams
    rng = np.random.default_rng(1)
    pairs = [(_rng_seq(rng, lx), _rng_seq(rng, ly))
             for lx, ly in ((120, 90), (300, 310), (7, 1), (55, 200))]
    reps = ([(rng.integers(1, 5, len(x)), rng.integers(1, 5, len(y)))
             for x, y in pairs] if rle else None)
    sm = StateMachineParams.default_nucleotide()
    tabs = pairhmm.PairHmmTables.from_params(
        sm, repeat=RepeatSubMatrix.empty() if rle else None, device="cpu")
    batch = pairhmm.make_batch(pairs, rep_pairs=reps, device="cpu")
    for lut in (True, False):
        want = chip_smoke.k1_work(batch, tabs, lut)
        B, Lx = batch.xs.shape
        got = roofline.k1_work(B, Lx, batch.ys.shape[1],
                               batch.lxs.numpy(), batch.lys.numpy(), lut,
                               rle)
        assert got == want


def _items(rng, n, lx_range, expansion_anchor=37):
    out = []
    for i in range(n):
        lx = int(rng.integers(*lx_range))
        x = _rng_seq(rng, lx)
        y = x.copy()
        flip = rng.random(lx) < 0.05
        y[flip] = (y[flip] + 1) % 4
        anchors = [(j, j) for j in range(15, lx - 15, expansion_anchor)]
        out.append({"x_sym": x, "y_sym": y, "anchors": anchors,
                    "strand": i % 2})
    return out


def _shapes(items, expansion):
    return [roofline.ItemShape(len(it["x_sym"]), len(it["y_sym"]),
                               ref.build_band(it["anchors"], len(it["x_sym"]),
                                              len(it["y_sym"]), expansion))
            for it in items]


def test_band_geometry_and_route():
    from margin_tpu_torch.ops import banded
    rng = np.random.default_rng(2)
    for it in _items(rng, 6, (50, 400)) + _items(rng, 2, (9000, 9100), 400):
        lx, ly = len(it["x_sym"]), len(it["y_sym"])
        for expansion in (2, 20, 120):
            geom = banded.BandGeometry.build(it["anchors"], lx, ly,
                                             expansion, smooth=True)
            shape = roofline.ItemShape(lx, ly, ref.build_band(
                it["anchors"], lx, ly, expansion))
            assert shape.w_pad == geom.w_pad
            assert shape.cells == banded._true_band_cells(geom)
            assert {"host": "host", "seg": "k3", "pack": "k2"}[
                banded._route(geom)] == shape.route
            assert shape.bucket == banded._bucket_w(geom.w_pad)


@pytest.mark.parametrize("lut", [True, False])
def test_k2_k3_counts(lut):
    """A pack of items of one width bucket, as the program packs them."""
    from margin_tpu_torch.ops import cuda_banded, pairhmm
    from margin_tpu_torch.params import StateMachineParams
    rng = np.random.default_rng(3)
    expansion = 20
    items = _items(rng, 5, (100, 600))
    shapes = _shapes(items, expansion)
    w = shapes[0].bucket
    assert all(s.bucket == w for s in shapes)
    tabs = pairhmm.PairHmmTables.from_params(
        StateMachineParams.default_nucleotide(), device="cpu")
    pack = cuda_banded._pack_host(tabs, items, w, expansion, False, False,
                                  device="cpu")
    n_words = 1234
    k2 = [roofline.k2_work(s, lut, False) for s in shapes]
    assert (sum(k[0][0] for k in k2), sum(k[0][1] for k in k2)) == \
        chip_smoke.k2_work(pack, lut, "fwd")
    want = chip_smoke.words_work(pack, lut, n_words)
    # the words (8 bytes each) and the pack's count (4) once a pack
    assert (sum(k[1][0] for k in k2),
            sum(k[1][1] for k in k2) + 8 * n_words + 4) == want
    assert roofline.SEG_D == cuda_banded.SEG_D
    k3 = [roofline.k3_work(s, lut, False) for s in shapes]
    for sweep, i in (("fwd", 0), ("bwd", 1)):
        want = chip_smoke.k3_work(pack, lut, sweep, cuda_banded.SEG_D[w],
                                  n_words)
        got = (sum(k[i][0] for k in k3),
               sum(k[i][1] for k in k3) + (8 * n_words if i else 0))
        assert got == want
