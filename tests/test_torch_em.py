"""Port of Baum-Welch EM (margin_tpu_torch.ops.em) and its transition
expectations (ops.banded.banded_expectations: kernels K2-fwd and K4 on a
CUDA device for bands up to 128 cells, K5-fwd and K5-exp for wider ones)
against the JAX package's on the same seeded pairs, among them pairs
anchored on their shared kmers as margin's EM anchors them
(getExpectationsUsingAnchors), whose bands are 130-340 cells wide.

The JAX side runs its XLA scan (`_banded_fb_core` with
compute_expectations); the CPU runs the port's plain twin
(cuda_banded.fb_expectations_plain), which keeps the JAX order: a sum over
the band for each diagonal, then a sequential float32 add. Expectations
hold rtol 1e-5 with an absolute floor of 1e-7 x the matrix sum. LUT totals
are checked bit for bit against JAX run in a subprocess with XLA's FMA
instructions off (as tests/test_torch_banded.py does); exact-logAdd
totals hold tests/test_native_fb.py's tolerance.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from margin_tpu.ops import banded as jbanded
from margin_tpu.ops import em as jem
from margin_tpu.ops import pairhmm as jpairhmm
from margin_tpu.params import StateMachineParams as JSM
from margin_tpu_torch.ops import banded, cuda_banded, em, native_fb, pairhmm
from margin_tpu_torch.params import StateMachineParams
from margin_tpu_torch.polish.kmers import get_kmer_alignment_anchors

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL_OF_SUM = 1e-5, 1e-7


def _pair(rng, lx, sub=0.08, dele=0.04):
    x = rng.integers(0, 4, lx).astype(np.int32)
    y = x.copy()
    flip = rng.random(lx) < sub
    y[flip] = (y[flip] + rng.integers(1, 4, int(flip.sum()))) % 4
    keep = rng.random(lx) > dele
    return x, y[keep], np.cumsum(keep) - 1, keep


def _cases():
    """(x, y, anchors, expansion, strand, ragged_left, ragged_right): short
    anchorless pairs and anchored pairs of 300-600 bases."""
    rng = np.random.default_rng(5)
    out = []
    for i, lx in enumerate((12, 60, 110)):
        x, y, _, _ = _pair(rng, lx)
        out.append((x, y, None, 20, i % 2, False, False))
    for i, lx in enumerate((300, 450, 600)):
        x, y, ypos, keep = _pair(rng, lx)
        xa = np.nonzero(keep)[0][::10][1:-1]
        anchors = [(int(a), int(ypos[a]), 6) for a in xa]
        out.append((x, y, anchors, 6, i % 2, i == 1, i == 2))
    return out


def _kmer_cases():
    """(x, y, kmer anchors, expansion 20, strand): three seeded pairs of
    300-520 bases at ~6% substitutions, deletions and insertions each,
    anchored by get_kmer_alignment_anchors, whose bands are 130-340 cells
    wide (K5's case)."""
    rng = np.random.default_rng(31)
    out = []
    while len(out) < 3:
        lx = int(rng.integers(300, 520))
        x = rng.integers(0, 4, lx).astype(np.int32)
        y = []
        for c in x:
            r = rng.random()
            if r < 0.06:
                continue
            y.append((c + rng.integers(1, 4)) % 4 if r < 0.12 else c)
            if r >= 0.12 and rng.random() < 0.042:
                y.append(rng.integers(0, 4))
        y = np.array(y, np.int32)
        anchors = get_kmer_alignment_anchors(x, y, 20)
        w = banded.BandGeometry.build(anchors, lx, len(y), 20,
                                      smooth=True).w_pad
        if 130 <= w <= 340:
            out.append((x, y, anchors, 20, len(out) % 2))
    return out


def _kmer_items():
    return [{"x_sym": x, "y_sym": y, "anchors": a, "strand": s}
            for x, y, a, _, s in _kmer_cases()]


def _jax_tables():
    return jpairhmm.PairHmmTables.from_params(JSM.default_nucleotide())


def _port_tables(device="cpu"):
    return pairhmm.PairHmmTables.from_params(
        StateMachineParams.default_nucleotide(), device=device)


def _jax_expectations(use_lut):
    tabs = _jax_tables()
    return [jbanded.banded_expectations(tabs, x, y, a, e, s, rl, rr,
                                        use_lut=use_lut)
            for x, y, a, e, s, rl, rr in _cases()]


def _port_expectations(use_lut, tables=None):
    tabs = tables or _port_tables()
    return [banded.banded_expectations(tabs, x, y, a, e, s, rl, rr,
                                       use_lut=use_lut)
            for x, y, a, e, s, rl, rr in _cases()]


def _assert_expectations(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape == (3, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_SUM * want.sum())


def jax_reference_without_fma(out_path):
    """Subprocess body: JAX LUT expectations and totals of every case and
    every kmer-anchored case with XLA's FMA contraction off."""
    res = _jax_expectations(True)
    tabs = _jax_tables()
    kmer = [jbanded.banded_expectations(tabs, x, y, a, e, s, use_lut=True)
            for x, y, a, e, s in _kmer_cases()]
    np.savez(out_path, e=np.stack([e for e, _ in res]),
             totals=np.array([t for _, t in res], np.float64),
             kmer_e=np.stack([e for e, _ in kmer]),
             kmer_totals=np.array([t for _, t in kmer], np.float64))


@pytest.fixture(scope="module")
def no_fma_reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("k4") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2")
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import jax; jax.config.update('jax_platforms', 'cpu')\n"
            "jax.config.update('jax_enable_x64', True)\n"
            "import test_torch_em as T\n"
            "T.jax_reference_without_fma(%r)\n"
            % (HERE, os.path.dirname(HERE), path))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=300)
    return dict(np.load(path))


def test_lut_expectations_match_jax(no_fma_reference):
    """LUT: the totals bit for bit, the expectations within the
    tolerance."""
    got = _port_expectations(True)
    assert np.array_equal(np.array([t for _, t in got]),
                          no_fma_reference["totals"])
    for (eg, _), ew in zip(got, no_fma_reference["e"]):
        assert eg.dtype == np.float64
        _assert_expectations(eg, ew)


def test_exact_expectations_match_jax():
    for (eg, tg), (ew, tw) in zip(_port_expectations(False),
                                  _jax_expectations(False)):
        assert tg == pytest.approx(tw, abs=2e-3)
        _assert_expectations(eg, ew)


def test_expectations_many_equal_single():
    """Packing problems together changes no problem's result."""
    tabs = _port_tables()
    items = [{"x_sym": x, "y_sym": y, "anchors": a or [], "strand": s,
              "ragged_left": rl, "ragged_right": rr}
             for x, y, a, _, s, rl, rr in _cases()[3:]]
    many = banded.banded_expectations_many(tabs, items, 6, use_lut=True)
    for (e1, t1), (e2, t2) in zip(many, _port_expectations(True)[3:]):
        assert t1 == t2 and np.array_equal(e1, e2)


def _em_pairs(n=5, lx=60):
    rng = np.random.default_rng(7)
    return [_pair(rng, lx, sub=0.1, dele=0.05)[:2] for _ in range(n)]


def test_em_iterations_match_jax():
    """Six Baum-Welch iterations (test_em's structure): the likelihood of
    each step within 1e-5 relative of margin_tpu's, the transitions
    within 1e-5."""
    pairs = _em_pairs()
    sm, jsm = StateMachineParams.default_nucleotide(), JSM.default_nucleotide()
    likes = []
    for _ in range(6):
        sm, like = em.em_iteration(sm, pairs, expansion=20, use_lut=True,
                                   device="cpu")
        jsm, jlike = jem.em_iteration(jsm, pairs, expansion=20, use_lut=True)
        assert like == pytest.approx(jlike, rel=1e-5)
        np.testing.assert_allclose(np.exp(sm.transition_vector()),
                                   np.exp(jsm.transition_vector()),
                                   atol=1e-5)
        likes.append(like)
    assert likes[-1] > likes[0]


def test_em_iteration_equals_the_loop():
    """em_iteration's packed solve equals adding each pair's expectations
    one by one with add_expectations."""
    pairs = _em_pairs(n=4)
    sm = StateMachineParams.default_nucleotide()
    got, like = em.em_iteration(sm, pairs, expansion=20, device="cpu")
    hmm = em.HmmExpectations(1e-12)
    tabs = pairhmm.PairHmmTables.from_params(sm, device="cpu")
    for x, y in pairs:
        hmm.add_expectations(tabs, x, y, expansion=20)
    assert hmm.likelihood == like
    hmm.normalise()
    assert hmm.to_state_machine_params(sm) == got


def test_wide_band_expectations_on_cpu_match_jax():
    """A band wider than 128 cells takes the plain twin on the CPU (exact
    logAdd: in process, XLA's FMAs move a LUT total by an ulp, and the
    expectations with it)."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 4, 200).astype(np.int32)
    y = rng.integers(0, 4, 190).astype(np.int32)
    eg, tg = banded.banded_expectations(_port_tables(), x, y, None, 20, 1)
    ew, tw = jbanded.banded_expectations(_jax_tables(), x, y, None, 20, 1)
    assert tg == pytest.approx(tw, abs=2e-3)
    _assert_expectations(eg, ew)


def test_wide_band_expectations_raise_on_card(monkeypatch):
    """A band wider than 128 cells no longer raises on a CUDA device:
    expectation_packs puts it in a pack of its width rounded up to 8, on
    which banded_expectations_many launches K5-fwd and K5-exp, while the
    narrow bands take K2-fwd and K4 (checked on the CPU with the device
    check patched and recording stubs in the launchers' place); the
    results are those of each problem solved alone."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 4, 200).astype(np.int32)
    items = [{"x_sym": x, "y_sym": x[:190], "anchors": [], "strand": 0}]
    items += [dict(it, anchors=list(it["anchors"])) for it in _kmer_items()]
    narrow = [{"x_sym": x, "y_sym": y, "anchors": a or [], "strand": s}
              for x, y, a, _, s, _, _ in _cases()[:2]]
    items += narrow
    monkeypatch.setattr(banded, "_on_card", lambda tables: True)
    calls = []

    def stub(name, plain):
        def launch(pack, *args):
            calls.append((name, pack.W, pack.B))
            return plain(pack, *args)
        return launch
    for attr, name, plain in (
            ("fb_forward_wide", "K5-fwd", cuda_banded.fb_forward_plain),
            ("fb_expectations_wide", "K5-exp",
             cuda_banded.fb_expectations_plain),
            ("fb_forward", "K2-fwd", cuda_banded.fb_forward_plain),
            ("fb_expectations", "K4", cuda_banded.fb_expectations_plain)):
        monkeypatch.setattr(cuda_banded, attr, stub(name, plain))
    tabs = _port_tables()
    got = banded.banded_expectations_many(tabs, items, 20, use_lut=True)
    widths = [banded._item_geom(it, 20, False).w_pad for it in items]
    wide = sorted({banded._round8(w) for w in widths if w > 128})
    assert len(wide) >= 2 and all(w > 128 for w in wide)
    assert sorted(w for n, w, _ in calls if n == "K5-fwd") == wide
    assert sorted(w for n, w, _ in calls if n == "K5-exp") == wide
    assert {w for n, w, _ in calls if n in ("K2-fwd", "K4")} <= {
        16, 32, 64, 128}
    assert sum(b for n, _, b in calls if n == "K5-fwd") == sum(
        w > 128 for w in widths)
    assert sum(b for n, _, b in calls if n == "K4") == len(narrow)
    for it, (e, t) in zip(items, got):
        (e1, t1), = banded.banded_expectations_many(tabs, [dict(it)], 20,
                                                    use_lut=True)
        assert t == t1 and np.array_equal(e, e1)


def test_kmer_anchored_wide_expectations_match_jax_exact():
    """Kmer-anchored pairs with bands of 130-340 cells, exact logAdd: the
    port's expectations (K5's plain twins on the CPU) against margin_tpu's
    banded_expectations in process, within test_native_fb.py's total
    tolerance and this file's expectation tolerance."""
    tabs, jtabs = _port_tables(), _jax_tables()
    for x, y, a, e, s in _kmer_cases():
        assert banded._item_geom({"x_sym": x, "y_sym": y, "anchors": a},
                                 e, False).w_pad > 128
        eg, tg = banded.banded_expectations(tabs, x, y, a, e, s)
        ew, tw = jbanded.banded_expectations(jtabs, x, y, a, e, s)
        assert tg == pytest.approx(tw, abs=2e-3)
        _assert_expectations(eg, ew)


def test_kmer_anchored_wide_expectations_match_jax_lut(no_fma_reference):
    """The same pairs under the LUT logAdd: totals bit for bit against JAX
    run with XLA's FMA contraction off, expectations within the
    tolerance."""
    tabs = _port_tables()
    got = [banded.banded_expectations(tabs, x, y, a, e, s, use_lut=True)
           for x, y, a, e, s in _kmer_cases()]
    assert np.array_equal(np.array([t for _, t in got]),
                          no_fma_reference["kmer_totals"])
    for (eg, _), ew in zip(got, no_fma_reference["kmer_e"]):
        _assert_expectations(eg, ew)


def _expectation_sums():
    """scripts/expectation_sums.py, the summation orders of one problem's
    expectation terms."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "expectation_sums", os.path.join(os.path.dirname(HERE), "scripts",
                                         "expectation_sums.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _share(got, want):
    """The largest |got - want| as a share of _assert_expectations'
    tolerance."""
    tol = RTOL * np.abs(want) + ATOL_OF_SUM * want.sum()
    return float((np.abs(got - want) / tol).max())


@pytest.mark.parametrize("use_lut", [False, True])
def test_em_deep_expectations_match_jax(use_lut):
    """At EM depth (one pair of 4060 bases anchored every 6 bases at W =
    208: 7958 diagonals, chip_smoke's deep k5 pair), the port's
    expectations (the plain twin on the CPU, margin_tpu's float32
    accumulator) against margin_tpu's within the tolerance, and the
    kernels' summation order (a lane's float32 running sums, then the
    warps; scripts/expectation_sums.py:lane_sums) too. The known gap: the
    float64 sum of the same terms lies 0.83 (exact) and 1.01 (LUT) of the
    tolerance from margin_tpu's on this pair (scripts/expectation_sums.py
    gives 1.08 against the twin's LUT sum), so a kernel summing nearer the
    float64 sum would fail the tolerance against margin_tpu at this
    depth."""
    items, exp, _ = _k5_items(208, lxs=(4060,))
    it = items[0]
    args = (it["x_sym"], it["y_sym"], it["anchors"], exp, it["strand"])
    eg, tg = banded.banded_expectations(_port_tables(), *args,
                                        use_lut=use_lut)
    ew, tw = jbanded.banded_expectations(_jax_tables(), *args,
                                         use_lut=use_lut)
    assert tg == pytest.approx(tw, abs=2e-3)
    _assert_expectations(eg, ew)
    sums = _expectation_sums()
    geom = banded._item_geom(it, exp, False)
    pack = cuda_banded._pack_host(_port_tables(), [it],
                                  banded._round8(geom.w_pad), exp, False,
                                  False, [geom], device="cpu")
    terms = sums.terms_of(pack, use_lut)
    assert pack.W == 208 and terms.shape[0] == 7958
    _assert_expectations(sums.lane_sums(terms, terms.shape[0]), ew)
    assert _share(terms.astype(np.float64).sum(axis=(0, 3)), ew) > 0.5


def _wide_item():
    rng = np.random.default_rng(4)
    return [{"x_sym": rng.integers(0, 4, 150).astype(np.int32),
             "y_sym": rng.integers(0, 4, 140).astype(np.int32),
             "anchors": [], "strand": 1}]


def test_wide_band_posteriors_without_host_engine_raise_on_card(monkeypatch):
    """Without the host engine, wide bands on a CUDA device raise and name
    the missing engine; nothing carries on on the CPU twins."""
    monkeypatch.setattr(native_fb, "lib", lambda: None)
    monkeypatch.setattr(banded, "_on_card", lambda tables: True)
    with pytest.raises(RuntimeError, match="marginfb"):
        banded.banded_posteriors_many(_port_tables(), _wide_item(), 6,
                                      threshold=2.0, use_lut=True)


def test_wide_band_posteriors_without_host_engine_on_cpu(monkeypatch):
    """On the CPU the plain twins take wide bands when the host engine is
    missing, with the engine's total."""
    (_, want), = banded.banded_posteriors_many(
        _port_tables(), _wide_item(), 6, threshold=2.0, use_lut=True)
    monkeypatch.setattr(native_fb, "lib", lambda: None)
    banded.ROUTES.reset()
    (pairs, got), = banded.banded_posteriors_many(
        _port_tables(), _wide_item(), 6, threshold=2.0, use_lut=True)
    assert banded.ROUTES.host_items == 0
    assert got == pytest.approx(want, abs=2e-3)


# anchor expansion that puts a problem in each width bucket
WIDTH_EXPANSION = {16: 4, 32: 20, 64: 50, 128: 110}


def _k4_pack(w, device, deep=False):
    """Five anchored problems of band width bucket w (mixed strands,
    ragged ends), or one deep pair of ~8000 diagonals at W = 32."""
    rng = np.random.default_rng(40 + w + deep)
    exp = 20 if deep else WIDTH_EXPANSION[w]
    items = []
    for i, lx in enumerate((4000,) if deep else (90, 140, 180, 120, 200)):
        x, y, ypos, keep = _pair(rng, lx)
        xa = np.nonzero(keep)[0][::6][1:-1]
        items.append({"x_sym": x, "y_sym": y, "strand": i % 2,
                      "ragged_left": i == 1, "ragged_right": i == 2,
                      "anchors": [(int(a), int(ypos[a]), exp) for a in xa]})
    geoms = [banded._item_geom(it, exp, False) for it in items]
    w_pad = banded._bucket_w(max(g.w_pad for g in geoms))
    assert w_pad == w
    return cuda_banded._pack_host(_port_tables(device), items, w_pad, exp,
                                  False, False, geoms, device=device)


@pytest.mark.cuda
def test_k4_matches_plain():
    """K4 against its twin at every width bucket and on one deep pair, both
    logAdds, at the launch's chunk depth and at a chunk of 7 diagonals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    packs = [_k4_pack(w, "cuda") for w in (16, 32, 64, 128)]
    packs.append(_k4_pack(32, "cuda", deep=True))
    for pack in packs:
        for use_lut in (True, False):
            fwd, tot = cuda_banded.fb_forward(pack, use_lut)
            want = cuda_banded.fb_expectations_plain(pack, fwd, tot, use_lut)
            for chunk in (None, 7):
                got = cuda_banded.fb_expectations(pack, fwd, tot, use_lut,
                                                  chunk)
                torch.cuda.synchronize()
                for g, w in zip(got.cpu().numpy(), want.cpu().numpy()):
                    _assert_expectations(g, w)


def _k5_items(w, rle=False, lxs=(1500, 600, 1100)):
    """Anchored problems of lxs bases (three of 600-1500 by default) whose
    bands are w cells wide (the anchor expansion w - 7): (items,
    expansion, the generator they were drawn from)."""
    rng = np.random.default_rng(60 + w)
    exp = w - 7
    items = []
    for i, lx in enumerate(lxs):
        x, y, ypos, keep = _pair(rng, lx)
        xa = np.nonzero(keep)[0][::6][1:-1]
        it = {"x_sym": x, "y_sym": y, "strand": i % 2,
              "ragged_left": i == 1, "ragged_right": i == 2,
              "anchors": [(int(a), int(ypos[a]), exp) for a in xa]}
        if rle:
            it["rep_x"] = rng.integers(1, 12, lx).astype(np.int32)
            it["rep_y"] = rng.integers(1, 12, len(y)).astype(np.int32)
        items.append(it)
    return items, exp, rng


def _k5_pack(w, device, rle=False):
    """_k5_items(w) packed at their widest band rounded up to 8, for
    K5."""
    items, exp, rng = _k5_items(w, rle)
    geoms = [banded._item_geom(it, exp, False) for it in items]
    w_pad = banded._round8(max(g.w_pad for g in geoms))
    assert w_pad > 128
    tabs = _port_tables(device)
    if rle:
        from margin_tpu_torch.params import RepeatSubMatrix
        rep = RepeatSubMatrix.empty()
        rep.log_probs = rng.uniform(-4.0, -0.05, (4, 51, 51))
        tabs = pairhmm.PairHmmTables.from_params(
            StateMachineParams.default_nucleotide(), repeat=rep,
            device=device)
    return cuda_banded._pack_host(tabs, items, w_pad, exp, False, rle, geoms,
                                  device=device)


@pytest.mark.parametrize("w, design", [
    (136, "step"), (208, "step"), (424, "step"), (512, "step"),
    (132, "strided"), (520, "strided"), (640, "strided"),
    (1064, "strided")])
def test_k5_design_of_width(w, design):
    """A K5 pack of 136..512 cells, a multiple of 8 (the packs' width
    rounding), runs on K2's step; any other width on the strided kernels,
    which the checks may also force at the step's widths, while the step
    design refuses a width it has no block for."""
    assert cuda_banded.k5_design(w) == design
    pack = cuda_banded._pack_host(_port_tables(), [{
        "x_sym": np.zeros(40, np.int32), "y_sym": np.zeros(40, np.int32),
        "anchors": [], "strand": 0}], w, 20, False, False, device="cpu")
    assert cuda_banded._k5_design(pack, None) == design
    assert cuda_banded._k5_design(pack, "strided") == "strided"
    if design == "strided":
        with pytest.raises(ValueError):
            cuda_banded._k5_design(pack, "step")


def test_wide_band_design_follows_width(monkeypatch):
    """K5's wrappers pick the design from the pack's width before the
    launch: the kmer-anchored bands (136..512 cells once rounded up to 8)
    take K2's step, the _k5_items(1057) problems (packs of 576..1064) the
    strided kernels; checked on the CPU with the device check patched and
    recording stubs in the launchers' place (filling the outputs from the
    plain twins). The counters count every launch and each design's, and
    the results are those of each problem solved alone."""
    monkeypatch.setattr(cuda_banded, "_on_card", lambda pack: True)
    calls = []

    def fwd_stub(design):
        def launch(pack, use_lut, fwd, totals, *ring_shared):
            assert len(ring_shared) == (design == "strided")
            calls.append(("K5-fwd", design, pack.W, pack.B))
            f, t = cuda_banded.fb_forward_plain(pack, use_lut)
            fwd.copy_(f)
            totals.copy_(t)
            return 0
        return launch

    def exp_stub(design):
        def launch(pack, use_lut, fwd, totals, out, *ring_shared):
            assert len(ring_shared) == (design == "strided")
            calls.append(("K5-exp", design, pack.W, pack.B))
            out.copy_(cuda_banded.fb_expectations_plain(pack, fwd, totals,
                                                        use_lut))
            return 0
        return launch
    for d in cuda_banded.K5_DESIGNS:
        monkeypatch.setitem(cuda_banded.K5_FORWARD, d, fwd_stub(d))
        monkeypatch.setitem(cuda_banded.K5_EXPECT, d, exp_stub(d))
    for c in (cuda_banded.FB_FORWARD_WIDE, cuda_banded.FB_EXPECT_WIDE):
        monkeypatch.setattr(c, "launches", 0)
        monkeypatch.setattr(c, "designs", dict.fromkeys(
            cuda_banded.K5_DESIGNS, 0))
    tabs = _port_tables()
    groups = [(_kmer_items(), 20, "step"),
              (_k5_items(1057)[0], 1050, "strided")]
    want = dict.fromkeys(cuda_banded.K5_DESIGNS, 0)
    runs = []
    for items, exp, design in groups:
        widths = [banded._round8(banded._item_geom(it, exp, False).w_pad)
                  for it in items]
        assert all((128 < w <= 512) == (design == "step") for w in widths)
        assert {cuda_banded.k5_design(w) for w in widths} == {design}
        got = banded.banded_expectations_many(tabs, items, exp, use_lut=True)
        mine = [c for c in calls if c[1] == design]
        for name in ("K5-fwd", "K5-exp"):
            assert sorted(w for n, _, w, _ in mine if n == name) == sorted(
                set(widths))
            assert sum(b for n, _, _, b in mine if n == name) == len(items)
        want[design] += len(set(widths))
        runs.append((items, exp, got))
    assert want["step"] > 0 and want["strided"] > 0
    assert len(calls) == 2 * sum(want.values())
    for c in (cuda_banded.FB_FORWARD_WIDE, cuda_banded.FB_EXPECT_WIDE):
        assert c.designs == want and c.launches == sum(want.values())
    for items, exp, got in runs:
        for it, (e, t) in zip(items, got):
            (e1, t1), = banded.banded_expectations_many(tabs, [dict(it)],
                                                        exp, use_lut=True)
            assert t == t1 and np.array_equal(e, e1)


@pytest.mark.cuda
def test_k5_matches_plain():
    """K5-fwd and K5-exp against their twins in both designs: K2's step at
    widths 136, 256, 424 and 512 (6..16 warps; the strided design forced
    there too), the strided design at
    640 and > 1024 (threads striding over the band) with the ring of
    diagonals in shared and in device memory; RLE off and on, both
    logAdds: the forward grid and totals bit for bit under the LUT
    (within 1e-4 exact), the expectations within this file's tolerance;
    each launch counted under its design."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    packs = [_k5_pack(w, "cuda", rle) for w in (136, 256, 424, 512, 640, 1057)
             for rle in (False, True)]
    assert packs[-1].W > 1024
    for pack in packs:   # the wrapper's layout is the kernel's
        for shared in (0, 1):
            assert cuda_banded._k5().k5_smem_bytes(pack.W, shared) == \
                cuda_banded._k5_smem_bytes(pack.W, bool(shared))
    for pack in packs:
        step = pack.W <= 512
        assert cuda_banded.k5_design(pack.W) == ("step" if step
                                                 else "strided")
        runs = ([{}, {"design": "strided"}] if step
                else [{}, {"ring_shared": False}])
        for use_lut in (True, False):
            fp, tp = cuda_banded.fb_forward_plain(pack, use_lut)
            ep = cuda_banded.fb_expectations_plain(pack, fp, tp, use_lut)
            for kw in runs:
                design = kw.get("design", cuda_banded.k5_design(pack.W))
                n_f = cuda_banded.FB_FORWARD_WIDE.designs[design]
                n_e = cuda_banded.FB_EXPECT_WIDE.designs[design]
                fk, tk = cuda_banded.fb_forward_wide(pack, use_lut, **kw)
                ek = cuda_banded.fb_expectations_wide(pack, fp, tp, use_lut,
                                                      **kw)
                torch.cuda.synchronize()
                assert cuda_banded.FB_FORWARD_WIDE.designs[design] == n_f + 1
                assert cuda_banded.FB_EXPECT_WIDE.designs[design] == n_e + 1
                if use_lut:
                    assert torch.equal(tk, tp) and torch.equal(fk, fp)
                else:
                    assert (tk - tp).abs().max().item() <= 1e-4
                    assert (fk - fp).abs().max().item() <= 1e-4
                for g, w in zip(ek.cpu().numpy(), ep.cpu().numpy()):
                    _assert_expectations(g, w)


@pytest.mark.cuda
def test_k5_step_layout_matches_kernel():
    """The Python mirror of the step design's block (cuda_banded.k2_smem:
    K2's layout, its exchange slots sized by the block's 6..16 warps)
    equals the kernel's (k5_step_smem_bytes) at every width of the design,
    RLE on and off, at chunks 1, 7 and the deepest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    lib = cuda_banded._k5()
    for w in range(136, 513, 8):
        for rle in (True, False):
            for C in (1, 7, cuda_banded.k2_chunk(w, rle)):
                assert lib.k5_step_smem_bytes(w, C, int(rle)) == \
                    cuda_banded.k2_smem(w, C, rle)
