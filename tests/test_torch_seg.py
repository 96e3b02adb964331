"""The segmented banded forward-backward (K3-fwd / K3-bwd,
margin_tpu_torch.ops.cuda_banded) against the JAX package's segmented
Pallas kernels and against the port's monolithic K2, and the routing of
deep items to it (ops.banded).

The JAX side is `fb_posteriors_group_seg` (pallas_banded.py:1346) in
interpret mode with 64-diagonal segments (MARGIN_TPU_SEG_D=64, set in its
subprocess only), run with XLA's FMA contraction off so LUT bits compare
(see tests/test_torch_pairhmm.py). The CPU runs the port's plain twins;
the CUDA kernels are held against the same twins on the card
(test_seg_kernels_match_plain, and chip_smoke.py).
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from margin_tpu_torch.ops import banded, cuda_banded, pairhmm

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
EXPANSION = 6
SEG = 64
THRESHOLD = 0.01
# (rle, use_lut): RLE on and off, both logAdd flavours
CASES = [(False, True), (True, True), (True, False), (False, False)]


def _tables_np(rle):
    """Numpy tables, built by the JAX package the way both drivers load
    them (pairhmm.PairHmmTables.from_params)."""
    from margin_tpu.ops import pairhmm as jpairhmm
    from margin_tpu.params import RepeatSubMatrix, StateMachineParams
    rep = None
    if rle:
        rep = RepeatSubMatrix.empty()
        rep.log_probs = np.random.default_rng(11).uniform(-4.0, -0.05,
                                                          (4, 51, 51))
    return jpairhmm.PairHmmTables.from_params(
        StateMachineParams.default_nucleotide(), repeat=rep)


def _port_tables(rle, device="cpu"):
    return pairhmm.tables_like(_tables_np(rle), device=device)


def _own_tables(rle, device):
    """The same tables built by the port alone (the GPU machine has no
    JAX)."""
    from margin_tpu_torch.params import RepeatSubMatrix, StateMachineParams
    rep = None
    if rle:
        rep = RepeatSubMatrix.empty()
        rep.log_probs = np.random.default_rng(11).uniform(-4.0, -0.05,
                                                          (4, 51, 51))
    return pairhmm.PairHmmTables.from_params(
        StateMachineParams.default_nucleotide(), repeat=rep, device=device)


def _items(seed, rle, n=6):
    """n problems of a few hundred diagonals: mixed depths, both strands,
    ragged ends, anchors every 8 bases along the true alignment (one
    problem without anchors)."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        lx = int(rng.integers(60, 220))
        x = rng.integers(0, 4, lx).astype(np.int32)
        y = x.copy()
        flip = rng.random(lx) < 0.06
        y[flip] = (y[flip] + rng.integers(1, 4, int(flip.sum()))) % 4
        keep = rng.random(lx) > 0.03
        ypos = np.cumsum(keep) - 1
        y = y[keep]
        if i == n - 1:
            x, y, anchors = x[:24], y[:22], []
        else:
            anchors = [(int(a), int(ypos[a]), 4)
                       for a in np.nonzero(keep)[0][::8][1:-1]]
        it = {"x_sym": x, "y_sym": y, "strand": int(rng.integers(0, 2)),
              "anchors": anchors}
        if i % 3 == 1:
            it["ragged_left"] = True
        if i % 3 == 2:
            it["ragged_right"] = True
        if rle:
            it["rep_x"] = rng.integers(1, 60, len(x)).astype(np.int32)
            it["rep_y"] = rng.integers(1, 60, len(y)).astype(np.int32)
        items.append(it)
    return items


def _w_pad(items):
    return banded._bucket_w(max(banded._item_geom(dict(it), EXPANSION,
                                                  False).w_pad
                                for it in items))


def _port_pack(ci, device="cpu"):
    rle, _ = CASES[ci]
    items = _items(ci, rle)
    tables = (_port_tables(rle, device) if device == "cpu"
              else _own_tables(rle, device))
    return cuda_banded._pack_host(tables, items, _w_pad(items), EXPANSION,
                                  False, rle, device=device)


def _words(packed, n, nt=None):
    """(totals (n,) float32, {(lo, hi)}) of a fused readback; nt is the
    number of totals the readback carries (the JAX one pads problems)."""
    nt = n if nt is None else nt
    count = int(packed[0])
    totals = packed[1:1 + n].view(np.float32)
    lo = packed[1 + nt:1 + nt + count]
    hi = packed[1 + nt + count:1 + nt + 2 * count]
    return totals, set(zip(lo.tolist(), hi.tolist()))


def _by_cell(words):
    """{(hi word, k): scaled probability} of a word set."""
    return {(hi, lo >> 24): lo & 0xFFFFFF for lo, hi in words}


def jax_seg_reference(out_path):
    """Subprocess body: the JAX segmented kernels' readback per case."""
    os.environ["MARGIN_TPU_PALLAS"] = "interpret"
    os.environ["MARGIN_TPU_SEG_D"] = str(SEG)
    from margin_tpu.ops import pallas_banded as jpallas
    out = {}
    for ci, (rle, lut) in enumerate(CASES):
        items = _items(ci, rle)
        d_pad = max(len(it["x_sym"]) + len(it["y_sym"]) + 1 for it in items)
        packed, _, _ = jpallas.fb_posteriors_group_seg(
            _tables_np(rle), items, d_pad, _w_pad(items), EXPANSION, lut,
            False, rle, THRESHOLD, 1 << 17, 1 << 17)
        arr = np.asarray(packed)
        assert arr[0] <= 1 << 17 and arr[1] <= 1 << 17  # no overflow
        # [count, max_seg_count, totals (b_pad), lo (K), hi (K)]
        b_pad = max(64, -(-len(items) // 64) * 64)
        kb = (arr.size - 2 - b_pad) // 2
        lo = arr[2 + b_pad:2 + b_pad + kb]
        hi = arr[2 + b_pad + kb:]
        ok = hi != 0x7FFFFFFF
        out[f"count_{ci}"] = np.array([arr[0], ok.sum()])
        out[f"totals_{ci}"] = arr[2:2 + len(items)]
        out[f"lo_{ci}"] = lo[ok]
        out[f"hi_{ci}"] = hi[ok]
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_seg(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("k3") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2")
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import jax; jax.config.update('jax_platforms', 'cpu')\n"
            "import test_torch_seg as T\n"
            "T.jax_seg_reference(%r)\n"
            % (HERE, os.path.dirname(HERE), path))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=300)
    return dict(np.load(path))


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_seg_twin_matches_jax_seg_kernels(jax_seg, ci):
    _, lut = CASES[ci]
    pack = _port_pack(ci)
    got = cuda_banded.fb_posteriors_seg_plain(pack, lut, THRESHOLD,
                                              SEG).numpy()
    tot, words = _words(got, pack.B)
    jcount, jvalid = jax_seg[f"count_{ci}"]
    assert jcount == jvalid == len(words)
    jtot = jax_seg[f"totals_{ci}"].view(np.float32)
    jwords = set(zip(jax_seg[f"lo_{ci}"].tolist(),
                     jax_seg[f"hi_{ci}"].tolist()))
    mine, theirs = _by_cell(words), _by_cell(jwords)
    if lut:
        # identical totals and (problem, state, diagonal, k) cells; the
        # scaled probabilities floor(p * 1e7) may differ by one unit: exp()
        # is XLA's polynomial on one side and PyTorch's on the other, a
        # last-bit float32 difference (ROADMAP queue 3)
        assert np.array_equal(tot, jtot), np.abs(tot - jtot).max()
        assert mine.keys() == theirs.keys()
        assert max(abs(mine[c] - theirs[c]) for c in mine) <= 1
        return
    # exact logAdd: tests/test_native_fb.py's tolerances (totals 2e-3,
    # probabilities 2e-4)
    np.testing.assert_allclose(tot, jtot, atol=2e-3, rtol=0)
    common = mine.keys() & theirs.keys()
    assert len(common) >= 0.98 * max(len(mine), len(theirs))
    assert max(abs(mine[c] - theirs[c]) for c in common) <= 2000


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_seg_twin_matches_k2_twin(ci):
    """Same pack through the monolithic twins + extraction and through the
    segmented twins (segments of 32, so most problems cross seams):
    identical totals and words."""
    _, lut = CASES[ci]
    pack = _port_pack(ci)
    fwd, totals = cuda_banded.fb_forward_plain(pack, lut)
    post = cuda_banded.fb_backward_plain(pack, fwd, totals, lut)
    k2 = banded.extract_packed(post, totals, pack, THRESHOLD).numpy()
    k3 = cuda_banded.fb_posteriors_seg_plain(pack, lut, THRESHOLD,
                                             32).numpy()
    t2, w2 = _words(k2, pack.B)
    t3, w3 = _words(k3, pack.B)
    assert np.array_equal(t2, t3)
    assert w2 == w3 and len(w3) > 0


# the JAX package's segment depths (`_seg_d`, pallas_banded.py:863-870),
# sized for a device-memory recompute scratch
JAX_SEG_D = {16: 2048, 32: 2048, 64: 1024, 128: 512}
# anchor expansion that puts the _items problems in each width bucket
BUCKET_EXPANSION = {16: 0, 32: 10, 64: 50, 128: 110}


@pytest.mark.parametrize("rle", [True, False])
@pytest.mark.parametrize("w", [16, 32, 64, 128])
def test_k3_launch_config(w, rle):
    """Every width bucket gets a segment depth whose K3 blocks fit the
    shared memory a Hopper block may use; one step more does not, and the
    helper raises for it."""
    S = cuda_banded.seg_depth(w, rle)
    assert S >= 2 and S % cuda_banded.SEG_STEP == 0
    for sweep in ("fwd", "bwd"):
        assert cuda_banded.k3_smem(w, S, rle, sweep) <= 232_448
    with pytest.raises(ValueError):
        cuda_banded.k3_smem(w, S + cuda_banded.SEG_STEP, rle, "bwd")
    # SEG_D holds the depth of a block with RLE on, which fits RLE off too
    assert cuda_banded.SEG_D[w] == cuda_banded.seg_depth(w, True) <= S
    assert cuda_banded.k3_smem(w, cuda_banded.SEG_D[w], rle, "bwd") <= \
        cuda_banded.MAX_SMEM


def _bucket_pack(w, device="cpu"):
    """A pack of width bucket w: four anchored problems of 140-430
    diagonals (RLE on, both strands, ragged ends)."""
    exp = BUCKET_EXPANSION[w]
    items = _items(20 + w, True, 5)[:4]
    for it in items:
        it["anchors"] = [(a[0], a[1], exp) for a in it["anchors"]]
    tables = (_port_tables(True) if device == "cpu"
              else _own_tables(True, device))
    pack = cuda_banded._pack_host(tables, items, _w_pad_exp(items, exp), exp,
                                  False, True, device=device)
    assert pack.W == w
    return pack


def _w_pad_exp(items, exp):
    return banded._bucket_w(max(banded._item_geom(dict(it), exp, False).w_pad
                                for it in items))


@functools.lru_cache(maxsize=None)
def _k2_twin_words(w):
    """The K2 twin's (totals, words) of _bucket_pack(w)."""
    pack = _bucket_pack(w)
    fwd, totals = cuda_banded.fb_forward_plain(pack, True)
    post = cuda_banded.fb_backward_plain(pack, fwd, totals, True)
    return _words(banded.extract_packed(post, totals, pack,
                                        THRESHOLD).numpy(), pack.B)


@pytest.mark.parametrize("depth", ["SEG_D", 32, "JAX"])
@pytest.mark.parametrize("w", [16, 32, 64, 128])
def test_seg_twin_depths_match_k2_twin(w, depth):
    """Results do not depend on the segment depth: at the launch's SEG_D[w]
    (several segments a problem at W = 64 and 128), at 32 and at the JAX
    package's depths (one segment), the segmented twins give the K2
    twin's totals and words, bit for bit."""
    S = {"SEG_D": cuda_banded.SEG_D[w], "JAX": JAX_SEG_D[w]}.get(depth,
                                                                  depth)
    pack = _bucket_pack(w)
    got = _words(cuda_banded.fb_posteriors_seg_plain(pack, True, THRESHOLD,
                                                     S).numpy(), pack.B)
    want = _k2_twin_words(w)
    assert np.array_equal(got[0], want[0])
    assert got[1] == want[1] and len(got[1]) > 0


def test_checkpoints_hold_the_forward_carry():
    """seg_forward_plain's checkpoint of segment s is the monolithic
    forward's diagonals s*S-1 and s*S-2."""
    pack = _port_pack(0)
    fwd, totals = cuda_banded.fb_forward_plain(pack, True)
    ckpt, t3 = cuda_banded.seg_forward_plain(pack, True, 32)
    seg_off, n_total = cuda_banded.seg_layout(pack, 32)
    assert ckpt.shape[0] == n_total and torch.equal(totals, t3)
    for b in range(pack.B):
        d = int(pack.lxs[b] + pack.lys[b])
        for s in range(1, d // 32 + 1):
            row = int(pack.geo_off[b]) + 32 * s
            c = ckpt[int(seg_off[b]) + s]
            assert torch.equal(c[0], fwd[row - 1])
            assert torch.equal(c[1], fwd[row - 2])


def test_deep_items_take_the_seg_route(monkeypatch):
    """An item with more than SEG_MIN_D diagonals takes the segmented route
    and counts in ROUTES.seg_items; the results equal the monolithic
    route's."""
    items = _items(7, False)
    want = banded.banded_posteriors_many(_port_tables(False),
                                         [dict(it) for it in items],
                                         EXPANSION, threshold=THRESHOLD,
                                         use_lut=True)
    monkeypatch.setattr(banded, "SEG_MIN_D", 200)
    monkeypatch.setitem(cuda_banded.SEG_D, 16, 48)
    monkeypatch.setitem(cuda_banded.SEG_D, 32, 48)
    deep = sum(len(it["x_sym"]) + len(it["y_sym"]) + 1 > 200 for it in items)
    assert 0 < deep < len(items)
    banded.ROUTES.reset()
    got = banded.banded_posteriors_many(_port_tables(False),
                                        [dict(it) for it in items],
                                        EXPANSION, threshold=THRESHOLD,
                                        use_lut=True)
    assert banded.ROUTES.seg_items == deep
    assert banded.ROUTES.pack_items == len(items) - deep
    assert banded.ROUTES.seg_packs >= 1
    for (gp, gt), (wp, wt) in zip(got, want):
        assert gt == wt
        for a, b in zip(gp, wp):
            assert np.array_equal(a, b)


def test_route_by_depth_and_width():
    """The route is a property of the item: wide bands and depths beyond
    the extraction word take the host engine, depths over SEG_MIN_D the
    segmented kernels."""
    def geom(lx, ly, w):
        z = np.zeros(1, np.int32)
        return banded.BandGeometry(lx, ly, lx + ly + 1, w, z, z, z, z)
    assert banded._route(geom(5000, 5000, 20)) == "pack"
    assert banded._route(geom(9000, 9000, 20)) == "seg"
    assert banded._route(geom(9000, 9000, 129)) == "host"
    assert banded._route(geom(1 << 21, 1 << 21, 20)) == "host"


@pytest.mark.cuda
def test_seg_kernels_match_plain():
    """The kernels against their twins: the CASES packs at S = 64 (both
    logAdds, RLE on and off, a small first capacity so K3-bwd re-runs),
    and a pack of every width bucket at its SEG_D (LUT, RLE on)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    runs = [(_port_pack(ci, device="cuda"), lut, SEG)
            for ci, (rle, lut) in enumerate(CASES)]
    runs += [(_bucket_pack(w, "cuda"), True, cuda_banded.SEG_D[w])
             for w in (16, 32, 64, 128)]
    for pack, lut, S in runs:
        ckpt, tk = cuda_banded.seg_forward(pack, lut, S)
        lo, hi = cuda_banded.seg_backward(pack, ckpt, tk, lut, S, THRESHOLD,
                                          cap=64)
        got = cuda_banded._fused(tk, lo, hi).cpu().numpy()
        cp, tp = cuda_banded.seg_forward_plain(pack, lut, S)
        want = cuda_banded._fused(tp, *cuda_banded.seg_backward_plain(
            pack, cp, tp, lut, S, THRESHOLD)).cpu().numpy()
        tg, wg = _words(got, pack.B)
        tw, ww = _words(want, pack.B)
        if lut:
            assert torch.equal(ckpt, cp)
            assert np.array_equal(tg, tw) and wg == ww
        else:
            assert np.abs(tg - tw).max() <= 1e-4
            assert {(h, lo >> 24) for lo, h in wg} == \
                {(h, lo >> 24) for lo, h in ww}


@pytest.mark.cuda
def test_seg_kernels_refuse_a_segment_beyond_the_block():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    # the wrapper's layout is the kernel's
    lib = cuda_banded._k3()
    for w in (16, 32, 64, 128):
        for rle in (0, 1):
            for bwd, sweep in ((0, "fwd"), (1, "bwd")):
                assert lib.k3_smem_bytes(w, cuda_banded.SEG_D[w], rle, bwd) \
                    == cuda_banded.k3_smem(w, cuda_banded.SEG_D[w], rle,
                                           sweep)
    pack = _bucket_pack(128, "cuda")
    too_deep = cuda_banded.SEG_D[128] + cuda_banded.SEG_STEP
    with pytest.raises(ValueError):
        cuda_banded.seg_forward(pack, True, too_deep)
    ckpt, tk = cuda_banded.seg_forward_plain(pack, True, too_deep)
    with pytest.raises(ValueError):
        cuda_banded.seg_backward(pack, ckpt, tk, True, too_deep, THRESHOLD)
