"""Port kernels K2-fwd / K2-bwd (margin_tpu_torch.ops.cuda_banded) and the
batched banded solve (ops.banded.banded_posteriors_many) against the JAX
package's Pallas kernels on the same seeded inputs.

The JAX side runs its Pallas kernels in interpret mode
(MARGIN_TPU_PALLAS=interpret). The CPU runs the port's plain PyTorch
twins; the CUDA kernels are held against the same twins on the card
(test_fb_kernels_match_plain, and chip_smoke.py).

As for K1 (tests/test_torch_pairhmm.py), XLA:CPU contracts a*b+c into
fused multiply-adds, so the bit-for-bit totals are checked against JAX run
in a subprocess with XLA's FMA instructions off; in-process comparisons
use tests/test_native_fb.py's tolerances.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from margin_tpu.ops import banded as jbanded
from margin_tpu.ops import pairhmm as jpairhmm
from margin_tpu.ops import pallas_banded as jpallas
from margin_tpu.params import RepeatSubMatrix, StateMachineParams
from margin_tpu_torch.ops import banded, cuda_banded, pairhmm

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
EXPANSION = 6
# (rle, use_lut, threshold, anchor spacing): RLE on and off, both
# flavours, pair extraction on (0.01) and totals only (2.0); spacing 6
# gives bands of width <= 16, spacing 12 width <= 32
CASES = [(False, True, 0.01, 6), (True, True, 2.0, 12),
         (True, False, 0.01, 6), (False, False, 2.0, 12)]
LUT_CASES = [ci for ci, c in enumerate(CASES) if c[1]]


def _jax_tables(rle):
    sm = StateMachineParams.default_nucleotide()
    rep = None
    if rle:
        rep = RepeatSubMatrix.empty()
        rep.log_probs = np.random.default_rng(11).uniform(-4.0, -0.05,
                                                          (4, 51, 51))
    return jpairhmm.PairHmmTables.from_params(sm, repeat=rep)


def _port_tables(rle, device="cpu"):
    jt = _jax_tables(rle)
    return pairhmm.tables_from_numpy(jt.match, jt.gap_x, jt.gap_y, jt.trans,
                                     jt.repeat, device=device)


def _items(seed, rle, spacing, n=5):
    """n problems (D <= 400): x random, y an erroneous copy of x, anchored
    every `spacing` bases along the true alignment; mixed strands, ragged
    ends, and (spacing > 6) one short anchorless problem."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        anchorless = spacing > 6 and i == n - 1
        lx = int(rng.integers(16, 24) if anchorless
                 else rng.integers(90, 200))
        x = rng.integers(0, 4, lx).astype(np.int32)
        y = x.copy()
        flip = rng.random(lx) < 0.06
        y[flip] = (y[flip] + rng.integers(1, 4, int(flip.sum()))) % 4
        keep = rng.random(lx) > 0.03
        ypos = np.cumsum(keep) - 1
        y = y[keep]
        xa = np.nonzero(keep)[0][::spacing][1:-1]
        it = {"x_sym": x, "y_sym": y, "strand": int(rng.integers(0, 2)),
              "anchors": ([] if anchorless else
                          [(int(a), int(ypos[a]), 4) for a in xa])}
        if i % 3 == 1:
            it["ragged_left"] = True
        if i % 3 == 2:
            it["ragged_right"] = True
        if rle:
            it["rep_x"] = rng.integers(1, 60, lx).astype(np.int32)
            it["rep_y"] = rng.integers(1, 60, len(y)).astype(np.int32)
        items.append(it)
    return items


def _case_items(ci):
    rle, _, _, spacing = CASES[ci]
    return _items(ci, rle, spacing)


def _fresh(items):
    return [{k: v for k, v in it.items() if k != "_geom"} for it in items]


def _jax_many(items, rle, use_lut, threshold):
    old = os.environ.get("MARGIN_TPU_PALLAS")
    os.environ["MARGIN_TPU_PALLAS"] = "interpret"
    try:
        return jbanded.banded_posteriors_many(
            _jax_tables(rle), _fresh(items), EXPANSION, threshold=threshold,
            use_lut=use_lut)
    finally:
        if old is None:
            os.environ.pop("MARGIN_TPU_PALLAS")
        else:
            os.environ["MARGIN_TPU_PALLAS"] = old


def _port_many(items, rle, use_lut, threshold):
    return banded.banded_posteriors_many(
        _port_tables(rle), _fresh(items), EXPANSION, threshold=threshold,
        use_lut=use_lut)


def jax_reference_without_fma(out_path):
    """Subprocess body: JAX (Pallas, interpret mode) totals of every case
    with XLA's FMA contraction off."""
    os.environ["MARGIN_TPU_PALLAS"] = "interpret"
    out = {}
    for ci in LUT_CASES:
        rle, use_lut, threshold, _ = CASES[ci]
        res = _jax_many(_case_items(ci), rle, use_lut, threshold)
        out[f"totals_{ci}"] = np.array([t for _, t in res], np.float64)
        out[f"pairs_{ci}"] = _flat_pairs(res)
    np.savez(out_path, **out)


def _flat_pairs(res):
    """(item, state, prob, x, y) rows of a banded_posteriors_many result."""
    rows = [np.concatenate([np.full((len(a), 2), (i, s)), a], axis=1)
            for i, (pairs, _) in enumerate(res) for s, a in enumerate(pairs)]
    return np.concatenate(rows).astype(np.int64).reshape(-1, 5)


@pytest.fixture(scope="module")
def no_fma_reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("k2") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2")
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import jax; jax.config.update('jax_platforms', 'cpu')\n"
            "jax.config.update('jax_enable_x64', True)\n"
            "import test_torch_banded as T\n"
            "T.jax_reference_without_fma(%r)\n"
            % (HERE, os.path.dirname(HERE), path))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=300)
    return dict(np.load(path))


def _pair_dict(arr):
    return {(int(x), int(y)): int(p) for p, x, y in arr}


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_banded_posteriors_many_matches_pallas(ci):
    rle, use_lut, threshold, _ = CASES[ci]
    items = _case_items(ci)
    got = _port_many(items, rle, use_lut, threshold)
    want = _jax_many(items, rle, use_lut, threshold)
    assert len(got) == len(want)
    for (gp, gt), (wp, wt) in zip(got, want):
        # in-process XLA contracts FMAs and rounds exp differently:
        # tests/test_native_fb.py's tolerances
        assert gt == pytest.approx(wt, abs=2e-3)
        for a, b in zip(gp, wp):
            if threshold > 1.0:
                assert len(a) == 0 and len(b) == 0
                continue
            ka, kb = _pair_dict(a), _pair_dict(b)
            common = set(ka) & set(kb)
            assert len(common) >= 0.98 * max(len(ka), len(kb), 1)
            for key in common:
                assert abs(ka[key] - kb[key]) <= 2000, key  # 2e-4 in prob
            assert a.dtype == np.int64 and a.shape[1] == 3
            if len(a):
                assert (np.diff(a[:, 1]) >= 0).all()


@pytest.mark.parametrize("ci", LUT_CASES)
def test_lut_totals_bit_identical(no_fma_reference, ci):
    rle, use_lut, threshold, _ = CASES[ci]
    res = _port_many(_case_items(ci), rle, use_lut, threshold)
    got = np.array([t for _, t in res])
    want = no_fma_reference[f"totals_{ci}"]
    assert np.array_equal(got, want), np.abs(got - want).max()
    gp, wp = _flat_pairs(res), no_fma_reference[f"pairs_{ci}"]
    # identical pair sets (item, state, x, y); the scaled probabilities
    # floor(p * 1e7) may differ by one unit: exp() is XLA's polynomial on
    # one side and PyTorch's on the other, a last-bit float32 difference
    assert gp.shape == wp.shape
    assert np.array_equal(gp[:, [0, 1, 3, 4]], wp[:, [0, 1, 3, 4]])
    assert np.abs(gp[:, 2] - wp[:, 2]).max(initial=0) <= 1


@pytest.mark.parametrize("ci", LUT_CASES)
def test_plain_fb_grids_match_pallas(ci):
    """fb_forward_plain / fb_backward_plain against the Pallas kernels'
    posterior grid and totals, cell for cell, on one pack."""
    rle = CASES[ci][0]
    items = _case_items(ci)
    w_pad = jbanded._bucket_w(max(jbanded._item_geom(it, EXPANSION, False)
                                  .w_pad for it in items))
    assert w_pad == (16 if CASES[ci][3] == 6 else 32)
    jt = _jax_tables(rle)
    d_pad = jbanded._bucket_dpad(max(len(it["x_sym"]) + len(it["y_sym"]) + 1
                                     for it in items))
    old = os.environ.get("MARGIN_TPU_PALLAS")
    os.environ["MARGIN_TPU_PALLAS"] = "interpret"
    try:
        jpost, jtot, *_ = jpallas.fb_posteriors_group(
            jt, _fresh(items), d_pad, w_pad, EXPANSION, True, False, rle)
    finally:
        if old is None:
            os.environ.pop("MARGIN_TPU_PALLAS")
        else:
            os.environ["MARGIN_TPU_PALLAS"] = old
    jpost = np.asarray(jpost)
    jtot = np.asarray(jtot)
    pack = cuda_banded._pack_host(_port_tables(rle), _fresh(items), w_pad,
                                  EXPANSION, False, rle, device="cpu")
    fwd, totals = cuda_banded.fb_forward_plain(pack, True)
    post = cuda_banded.fb_backward_plain(pack, fwd, totals, True).numpy()
    np.testing.assert_allclose(totals.numpy(), jtot[:len(items)], rtol=1e-6)
    off = pack.geo_off.numpy()
    for b, it in enumerate(items):
        d = len(it["x_sym"]) + len(it["y_sym"]) + 1
        mine = post[off[b]:off[b] + d]                  # (d, 3, W)
        theirs = np.transpose(jpost[:d, :, :, b], (0, 1, 2))
        np.testing.assert_allclose(mine, theirs, atol=2e-4, rtol=0)
        # the band mask is the same cell set
        assert np.array_equal(mine > 0, theirs > 0)


def test_wide_band_routes_to_host_engine():
    """Bands wider than 128 cells take the host C++ engine, as the JAX
    package routes them on an accelerator."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, 400).astype(np.int32)
    y = rng.integers(0, 4, 380).astype(np.int32)
    items = [{"x_sym": x, "y_sym": y, "anchors": [], "strand": 0}]
    banded.ROUTES.reset()
    (pairs, total), = banded.banded_posteriors_many(
        _port_tables(False), items, EXPANSION, threshold=2.0, use_lut=True)
    assert banded.ROUTES.host_items == 1 and banded.ROUTES.pack_items == 0
    assert np.isfinite(total) and total < 0


def test_wide_band_without_host_engine_takes_plain_twin(monkeypatch):
    """Without the host engine, wide bands run on the plain twins on the
    CPU; the total agrees with the host engine's."""
    from margin_tpu_torch.ops import native_fb
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4, 150).astype(np.int32)
    y = rng.integers(0, 4, 140).astype(np.int32)
    items = [{"x_sym": x, "y_sym": y, "anchors": [], "strand": 1}]
    (_, want), = banded.banded_posteriors_many(
        _port_tables(False), _fresh(items), EXPANSION, threshold=2.0,
        use_lut=True)
    monkeypatch.setattr(native_fb, "lib", lambda: None)
    (pairs, got), = banded.banded_posteriors_many(
        _port_tables(False), _fresh(items), EXPANSION, threshold=2.0,
        use_lut=True)
    assert all(len(p) == 0 for p in pairs)
    assert got == pytest.approx(want, abs=2e-3)


def test_pack_beyond_budget_raises(monkeypatch):
    """A problem whose own grids exceed the pack memory budget no longer
    raises: it takes the segmented kernels (K3), with the monolithic
    route's results."""
    items = _items(0, False, 6, n=1)
    want = _port_many(items, False, True, 0.01)
    monkeypatch.setattr(cuda_banded, "FB_GRID_BUDGET_BYTES", 1024)
    banded.ROUTES.reset()
    got = _port_many(items, False, True, 0.01)
    assert banded.ROUTES.seg_items == 1 and banded.ROUTES.pack_items == 0
    (gp, gt), = got
    (wp, wt), = want
    assert gt == wt and len(gp[0]) > 0
    for a, b in zip(gp, wp):
        assert np.array_equal(a, b)


# anchor expansion that puts _width_pack's problems in each width bucket
WIDTH_EXPANSION = {16: 4, 32: 20, 64: 50, 128: 110}


def _width_pack(w, rle, device="cpu"):
    """A pack of width bucket w: five anchored problems of 180-380
    diagonals (mixed strands, ragged ends)."""
    exp = WIDTH_EXPANSION[w]
    items = _items(30 + rle, rle, 6)
    for it in items:
        it["anchors"] = [(a[0], a[1], exp) for a in it["anchors"]]
    geoms = [banded._item_geom(it, exp, False) for it in items]
    w_pad = banded._bucket_w(max(g.w_pad for g in geoms))
    assert w_pad == w
    return cuda_banded._pack_host(_port_tables(rle, device), items, w_pad,
                                  exp, False, rle, geoms, device=device)


# K2's chunk depths at its width buckets (RLE on, off): the layout of
# the block with its exchange slots sized for 4 warps, which the wider
# blocks of K5's step design leave as they were
K2_BUCKET_CHUNK = {16: (443, 562), 32: (233, 291), 64: (119, 148),
                   128: (60, 74)}


@pytest.mark.parametrize("rle", [True, False])
@pytest.mark.parametrize("w", [16, 32, 64, 128, 136, 208, 256, 424, 512])
def test_k2_launch_config(w, rle):
    """Every width bucket, and every width K5 runs on K2's step (136..512
    cells at 6, 8, .., 16 warps: ceil(W / 32) rounded up to even), gets a
    chunk depth whose K2 block fits the shared memory a Hopper block may
    use; one diagonal more does not, and k2_smem raises for it. The
    buckets' depths are unchanged; at W = 512 a block still holds 14
    diagonals (RLE on)."""
    nw = cuda_banded.block_warps(w)
    if w <= 128:
        assert nw == max(1, -(-w // 32))
        C = cuda_banded.K2_CHUNK[(w, rle)]
        assert C == K2_BUCKET_CHUNK[w][0 if rle else 1]
    else:
        assert nw == 2 * -(-w // 64) and 6 <= nw <= 16
        assert cuda_banded.k5_design(w) == "step"
        C = cuda_banded.k2_chunk(w, rle)
        assert C >= (14 if rle else 18)
    assert C == cuda_banded.k2_chunk(w, rle) >= 1
    assert cuda_banded.k2_smem(w, C, rle) <= 232_448
    with pytest.raises(ValueError):
        cuda_banded.k2_smem(w, C + 1, rle)
    with pytest.raises(ValueError):
        cuda_banded.k2_smem(w, 0, rle)


def _jax_words(post, pack, totals, threshold):
    """margin_tpu's _device_extract_packed on a pack's posterior grid,
    laid out as it takes it ((D, 3, W, B), lane-last): the valid words as
    sorted int64 keys hi << 32 | lo."""
    B, W = pack.B, pack.W
    depth = [g.lx + g.ly + 1 for g in pack.geoms]
    D = max(depth)
    post_j = np.zeros((D, 3, W, B), np.float32)
    xb = np.zeros((B, D), np.int32)
    yb = np.zeros((B, D), np.int32)
    off = pack.geo_off.numpy()
    for b, (g, d) in enumerate(zip(pack.geoms, depth)):
        post_j[:d, :, :, b] = post[off[b]:off[b] + d]
        xb[b, :d] = g.x_base[:d]
        yb[b, :d] = g.y_base[:d]
    K = int(pack.n_rows * 3 * W)
    out = np.asarray(jbanded._device_extract_packed(
        post_j, xb, yb, np.ones(B, bool), totals, threshold, K=K))
    n = int(out[0])
    assert np.array_equal(out[1:1 + B].view(np.float32), totals)
    lo, hi = out[1 + B:1 + B + n], out[1 + B + K:1 + B + K + n]
    return np.sort((hi.astype(np.int64) << 32) | (lo.astype(np.int64)
                                                  & 0xFFFFFFFF))


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("w", [32, 128])
def test_words_plain_match_jax_extraction(w, rle):
    """fb_words_plain (the plain twin of K2-bwd WORDS: the twin's posterior
    grid, then extract_packed) against margin_tpu's
    _device_extract_packed on the same grid: the same words, compared as
    sorted keys."""
    pack = _width_pack(w, rle)
    fwd, totals = cuda_banded.fb_forward_plain(pack, True)
    post = cuda_banded.fb_backward_plain(pack, fwd, totals, True)
    lo, hi = cuda_banded.fb_words_plain(pack, fwd, totals, True, 0.01)
    got = np.sort((hi.numpy().astype(np.int64) << 32)
                  | (lo.numpy().astype(np.int64) & 0xFFFFFFFF))
    want = _jax_words(post.numpy(), pack, totals.numpy(), 0.01)
    assert len(got) > 0
    assert np.array_equal(got, want)


@pytest.mark.parametrize("w", [64, 128])
def test_banded_posteriors_many_takes_the_words_route(w, monkeypatch):
    """banded_posteriors_many solves every pack through
    fb_posteriors_words (K2-fwd, then K2-bwd WORDS on a card; its twins
    here), with no posterior grid (fb_posteriors_group is not called), and
    matches margin_tpu's Pallas route as
    test_banded_posteriors_many_matches_pallas does."""
    exp = WIDTH_EXPANSION[w]
    items = _items(50 + w, False, 6, n=3)
    for it in items:
        it["anchors"] = [(a[0], a[1], exp) for a in it["anchors"]]
    calls = []
    real = cuda_banded.fb_posteriors_words

    def words(*args, **kw):
        out = real(*args, **kw)
        calls.append(out[1].W)
        return out
    monkeypatch.setattr(cuda_banded, "fb_posteriors_words", words)
    monkeypatch.setattr(cuda_banded, "fb_posteriors_group", None)
    got = banded.banded_posteriors_many(_port_tables(False), _fresh(items),
                                        exp, threshold=0.01, use_lut=True)
    assert calls == [w]
    old = os.environ.get("MARGIN_TPU_PALLAS")
    os.environ["MARGIN_TPU_PALLAS"] = "interpret"
    try:
        want = jbanded.banded_posteriors_many(
            _jax_tables(False), _fresh(items), exp, threshold=0.01,
            use_lut=True)
    finally:
        if old is None:
            os.environ.pop("MARGIN_TPU_PALLAS")
        else:
            os.environ["MARGIN_TPU_PALLAS"] = old
    for (gp, gt), (wp, wt) in zip(got, want):
        assert gt == pytest.approx(wt, abs=2e-3)
        assert len(gp[0]) > 0
        for a, b in zip(gp, wp):
            ka, kb = _pair_dict(a), _pair_dict(b)
            common = set(ka) & set(kb)
            assert len(common) >= 0.98 * max(len(ka), len(kb))
            for key in common:
                assert abs(ka[key] - kb[key]) <= 2000, key


@pytest.mark.cuda
def test_fb_kernels_match_plain():
    """K2 against its twins at every width bucket, RLE on and off, both
    logAdds, at the launch's chunk depth and at a chunk of 7 diagonals
    (many chunk seams a problem), and on two packs with an anchorless
    problem."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    packs = [_width_pack(w, rle, "cuda") for w in (16, 32, 64, 128)
             for rle in (False, True)]
    for rle in (False, True):
        items = _items(20 + rle, rle, 6 + 6 * rle)
        tc = _port_tables(rle, device="cuda")
        geoms = [banded._item_geom(it, EXPANSION, False) for it in items]
        w = banded._bucket_w(max(g.w_pad for g in geoms))
        packs.append(cuda_banded._pack_host(tc, items, w, EXPANSION, False,
                                            rle, geoms, device="cuda"))
    for pack in packs:
        for use_lut in (True, False):
            fp, tp = cuda_banded.fb_forward_plain(pack, use_lut)
            pp = cuda_banded.fb_backward_plain(pack, fp, tp, use_lut)
            for chunk in (None, 7):
                fk, tk = cuda_banded.fb_forward(pack, use_lut, chunk)
                pk = cuda_banded.fb_backward(pack, fk, tk, use_lut, chunk)
                torch.cuda.synchronize()
                if use_lut:
                    assert torch.equal(tk, tp) and torch.equal(fk, fp)
                    assert torch.equal(pk, pp)
                else:
                    assert (tk - tp).abs().max().item() <= 1e-4
                    assert (pk - pp).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_fb_kernels_refuse_a_chunk_beyond_the_block():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    # the wrapper's layout is the kernel's
    lib = cuda_banded._k2()
    for w in (16, 32, 64, 128):
        for rle in (0, 1):
            for C in (1, 7, cuda_banded.K2_CHUNK[(w, bool(rle))]):
                assert lib.k2_smem_bytes(w, C, rle) == \
                    cuda_banded.k2_smem(w, C, bool(rle))
    pack = _width_pack(128, True, "cuda")
    fk, tk = cuda_banded.fb_forward(pack, True)
    with pytest.raises(ValueError):
        cuda_banded.fb_backward(pack, fk, tk, True,
                                cuda_banded.K2_CHUNK[(128, True)] + 1)
    with pytest.raises(ValueError):
        cuda_banded.fb_forward(pack, True,
                               cuda_banded.K2_CHUNK[(128, True)] + 1)
    # the kernel refuses a launch given less shared memory than its layout
    C = cuda_banded.K2_CHUNK[(128, True)]
    stream = torch.cuda.current_stream().cuda_stream
    need = lib.k2_smem_bytes(128, C, 1)
    for fn, bufs in ((lib.k2_forward, (fk, tk)),
                     (lib.k2_backward, (fk, tk, torch.empty_like(fk)))):
        args = cuda_banded._args(pack, *bufs)
        assert fn(args, pack.B, 128, C, 1, need - 1, stream) != 0
        assert fn(args, pack.B, 128, C, 1, need, stream) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_k2_bwd_words_match_extraction():
    """K2-bwd's WORDS instance against K2-bwd POST's grid through
    extract_packed (the same arithmetic on the card: identical words as
    sorted keys, both logAdds) and against fb_words_plain under the LUT,
    at every width bucket, RLE on and off, at its launch's chunk depth,
    at a chunk of 7 diagonals and with a capacity that overflows (the
    wrapper launches again with the exact count); its block layout is the
    wrapper's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    lib = cuda_banded._k2()
    for w in (16, 32, 64, 128):
        for rle in (0, 1):
            C = cuda_banded.K2_WORDS_CHUNK[(w, bool(rle))]
            assert lib.k2_words_smem_bytes(w, C, rle) == \
                cuda_banded.k2_smem(w, C, bool(rle), words=True)

    def keys(lo, hi):
        return torch.sort((hi.long() << 32) | (lo.long() & 0xFFFFFFFF)).values
    for w in (16, 32, 64, 128):
        for rle in (False, True):
            pack = _width_pack(w, rle, "cuda")
            for use_lut in (True, False):
                fk, tk = cuda_banded.fb_forward(pack, use_lut)
                pk = cuda_banded.fb_backward(pack, fk, tk, use_lut)
                packed = banded.extract_packed(pk, tk, pack, 0.01)
                n = int(packed[0])
                want = keys(packed[1 + pack.B:1 + pack.B + n],
                            packed[1 + pack.B + n:])
                assert n > 0
                for chunk, cap in ((None, None), (7, None), (None, 5)):
                    lo, hi = cuda_banded.fb_backward_words(
                        pack, fk, tk, use_lut, 0.01, cap=cap, chunk=chunk)
                    torch.cuda.synchronize()
                    assert torch.equal(keys(lo, hi), want)
                if use_lut:
                    fp, tp = cuda_banded.fb_forward_plain(pack, True)
                    lp, hp = cuda_banded.fb_words_plain(pack, fp, tp, True,
                                                        0.01)
                    assert torch.equal(keys(lp, hp), want)
