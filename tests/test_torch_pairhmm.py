"""Port kernel K1 (margin_tpu_torch.ops.pairhmm) against the JAX package's
dense pair-HMM forward on the same seeded inputs.

The CPU runs K1's plain PyTorch twin; the CUDA kernel is held against the
same twin on the card (test_forward_total_kernel_matches_plain, and
chip_smoke.py).

XLA:CPU contracts a*b+c into fused multiply-adds on CPUs that have them,
so the in-process JAX reference rounds the LUT cubic differently from the
reference C code, `native/` and the port (all unfused). The bit-for-bit
check therefore runs the JAX function in a subprocess with XLA's FMA
instructions off (--xla_cpu_max_isa=SSE4_2);
test_xla_cpu_fma_is_the_only_lut_difference shows that this is the whole
difference (ROADMAP queue 3).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from margin_tpu.ops import logmath as jlogmath
from margin_tpu.ops import pairhmm as jpairhmm
from margin_tpu.params import RepeatSubMatrix, StateMachineParams
from margin_tpu_torch import _ext
from margin_tpu_torch.ops import logmath, pairhmm

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = [(rle, seed) for rle in (False, True) for seed in (3, 4)]


def _repeat_matrix(rng):
    n = 51
    rep = RepeatSubMatrix.empty()
    rep.log_probs = rng.uniform(-4.0, -0.05, (4, n, n))
    return rep


def _jax_tables(rle: bool):
    rng = np.random.default_rng(11)
    return jpairhmm.PairHmmTables.from_params(
        StateMachineParams.default_nucleotide(),
        repeat=_repeat_matrix(rng) if rle else None)


def _port_tables(rle: bool, device="cpu"):
    jt = _jax_tables(rle)
    return pairhmm.tables_from_numpy(jt.match, jt.gap_x, jt.gap_y, jt.trans,
                                     jt.repeat, device=device)


def _inputs(seed, b=64, max_len=40, rle=False):
    """b pairs with ragged lx/ly in 1..max_len, both strands, ragged ends,
    a few N symbols and (RLE) run lengths beyond the clamp at 50."""
    rng = np.random.default_rng(seed)
    pairs, reps = [], []
    for _ in range(b):
        lx, ly = rng.integers(1, max_len + 1, 2)
        x = rng.integers(0, 4, lx).astype(np.uint8)
        y = rng.integers(0, 4, ly).astype(np.uint8)
        x[rng.random(lx) < 0.05] = 4
        pairs.append((x, y))
        if rle:
            reps.append((rng.integers(1, 60, lx), rng.integers(1, 60, ly)))
    kw = dict(strands=rng.integers(0, 2, b),
              ragged_left=rng.random(b) < 0.3,
              ragged_right=rng.random(b) < 0.3,
              rep_pairs=reps if rle else None)
    return pairs, kw


def _jax_totals(rle, seed, use_lut):
    pairs, kw = _inputs(seed, rle=rle)
    out = jpairhmm.forward_total(_jax_tables(rle),
                                 jpairhmm.make_batch(pairs, **kw),
                                 use_lut=use_lut)
    return np.asarray(out)[:len(pairs)]


def _port_totals(rle, seed, use_lut):
    pairs, kw = _inputs(seed, rle=rle)
    return pairhmm.forward_total(
        _port_tables(rle), pairhmm.make_batch(pairs, device="cpu", **kw),
        use_lut=use_lut).numpy()


def jax_reference_without_fma(out_path):
    """Subprocess body: the JAX LUT totals of every case, computed with
    XLA's FMA contraction off."""
    out = {f"{int(rle)}_{seed}": _jax_totals(rle, seed, True)
           for rle, seed in CASES}
    rng = np.random.default_rng(0)
    x = rng.uniform(-50, 0, 4096).astype(np.float32)
    y = (x + rng.uniform(-8, 8, x.size)).astype(np.float32)
    import jax
    out["logadd"] = np.asarray(jax.jit(jlogmath.log_add_lut_finite)(x, y))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def no_fma_reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("k1") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2")
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import jax; jax.config.update('jax_platforms', 'cpu')\n"
            "jax.config.update('jax_enable_x64', True)\n"
            "import test_torch_pairhmm as T\n"
            "T.jax_reference_without_fma(%r)\n"
            % (HERE, os.path.dirname(HERE), path))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=300)
    return dict(np.load(path))


@pytest.mark.parametrize("rle,seed", CASES)
def test_forward_total_lut_bit_identical(no_fma_reference, rle, seed):
    got = _port_totals(rle, seed, True)
    want = no_fma_reference[f"{int(rle)}_{seed}"]
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.array_equal(got, want), np.abs(got - want).max()


@pytest.mark.parametrize("rle", [False, True])
def test_forward_total_exact_within_tolerance(rle):
    got = _port_totals(rle, 7, False)
    want = _jax_totals(rle, 7, False)
    # exp/log1p differ between XLA and PyTorch in the last bits;
    # tests/test_native_fb.py's total tolerance
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_xla_cpu_fma_is_the_only_lut_difference(no_fma_reference):
    """The port's LUT logAdd equals XLA's bit for bit once XLA stops
    contracting a*b+c; with contraction on (this process), the forward
    totals differ from the port by float32 rounding only."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-50, 0, 4096).astype(np.float32)
    y = (x + rng.uniform(-8, 8, x.size)).astype(np.float32)
    port = logmath.log_add_lut(torch.tensor(x), torch.tensor(y)).numpy()
    assert np.array_equal(port, no_fma_reference["logadd"])
    got = _port_totals(False, 3, True)
    fused = _jax_totals(False, 3, True)
    np.testing.assert_allclose(got, fused, rtol=1e-6, atol=0)


def test_empty_pair_scores_log_one():
    tt = _port_tables(False)
    batch = pairhmm.make_batch([(np.zeros(0, np.uint8), np.zeros(0, np.uint8)),
                                (np.array([1], np.uint8),
                                 np.array([1], np.uint8))], device="cpu")
    out = pairhmm.forward_total(tt, batch, use_lut=True).numpy()
    assert out[0] == 0.0 and out[1] < 0.0


def test_cpu_batch_never_counts_a_launch():
    before = pairhmm.FORWARD_TOTAL.launches
    pairs, kw = _inputs(1, b=4)
    pairhmm.forward_total(_port_tables(False),
                          pairhmm.make_batch(pairs, device="cpu", **kw))
    assert pairhmm.FORWARD_TOTAL.launches == before


# (Ly, warps, rows a lane) of K1's launch
K1_LAUNCHES = [(0, 1, 1), (31, 1, 1), (32, 2, 1), (916, 29, 1),
               (1023, 32, 1), (1024, 17, 2), (8191, 32, 8)]


@pytest.mark.parametrize("ly,warps,rows", K1_LAUNCHES)
def test_k1_launch_config(ly, warps, rows):
    """A block a pair with the fewest rows a lane (1, 2, 4, 8) that keep
    it at <= 1024 threads; shared memory at Lx = 909: 44 table floats, 928
    bytes each of x symbols and run lengths, 2 x warps x 3 floats."""
    for rle, staged in ((True, 176 + 2 * 928), (False, 176 + 928)):
        cfg = pairhmm.k1_launch(909, ly, rle)
        assert (cfg.warps, cfg.rows, cfg.stage_x) == (warps, rows, True)
        assert cfg.smem == staged + 24 * warps <= _ext.MAX_SMEM
        assert 32 * warps * rows >= ly + 1 > 32 * (warps - 1) * rows
        assert 32 * warps <= 1024


def test_k1_launch_config_raises():
    """Beyond Ly = 8191; an Lx whose staged symbols and run lengths would
    exceed the 232,448 bytes a block may use still launches, with X read
    from device memory (the same Lx is staged without run lengths)."""
    with pytest.raises(ValueError):
        pairhmm.k1_launch(909, 8192, False)
    for ly, warps in ((31, 1), (916, 29)):
        cfg = pairhmm.k1_launch(150_000, ly, True)
        assert not cfg.stage_x and cfg.smem == 176 + 24 * warps
        cfg = pairhmm.k1_launch(150_000, ly, False)
        assert cfg.stage_x and cfg.smem == 176 + 150_016 + 24 * warps
        assert not pairhmm.k1_launch(240_000, ly, False).stage_x


def _shaped_inputs(seed, b, lx_range, ly_range, rle):
    """An empty pair, a pair with lx = 0, one with ly = 0, then b pairs
    with lx, ly uniform in their ranges, as `_inputs` makes them."""
    rng = np.random.default_rng(seed)
    lens = [(0, 0), (0, ly_range[1]), (lx_range[1], 0)] + [
        (int(rng.integers(lx_range[0], lx_range[1] + 1)),
         int(rng.integers(ly_range[0], ly_range[1] + 1))) for _ in range(b)]
    pairs, reps = [], []
    for lx, ly in lens:
        x = rng.integers(0, 4, lx).astype(np.uint8)
        x[rng.random(lx) < 0.05] = 4
        pairs.append((x, rng.integers(0, 4, ly).astype(np.uint8)))
        reps.append((rng.integers(1, 60, lx), rng.integers(1, 60, ly)))
    n = len(pairs)
    return pairs, dict(strands=rng.integers(0, 2, n),
                       ragged_left=rng.random(n) < 0.3,
                       ragged_right=rng.random(n) < 0.3,
                       rep_pairs=reps if rle else None)


# launch: (pairs, lx range, ly range, rows a lane R, padded Lx); "1warp"
# a block of one warp (Ly <= 31), "Xdev" X read from device memory (the
# batch padded beyond the Lx whose x symbols fit in shared memory)
K1_CUDA_CASES = {"1warp": (64, (1, 40), (1, 31), 1, None),
                 "R1": (64, (1, 300), (1, 300), 1, None),
                 "R2": (8, (1, 200), (1025, 2000), 2, None),
                 "R8": (4, (50, 120), (4100, 8191), 8, None),
                 "Xdev": (16, (1, 2000), (1, 300), 1, 240_000)}


@pytest.mark.cuda
@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("case", list(K1_CUDA_CASES))
def test_forward_total_kernel_matches_plain(case, rle):
    """K1 against its twin in each launch shape, RLE on and off, with
    ragged ends and empty pairs: LUT bit for bit, exact within 1e-4. A
    batch padded to Lx = 240,000 is held against the twin on the same
    pairs padded only to their longest x, and against the kernel there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b, lxr, lyr, rows, pad_x = K1_CUDA_CASES[case]
    tc = _port_tables(rle, device="cuda")
    pairs, kw = _shaped_inputs(5, b, lxr, lyr, rle)
    batch = pairhmm.make_batch(pairs, device="cuda", **kw)
    long = batch
    if pad_x is not None:
        long = pairhmm.make_batch(pairs, device="cuda", pad_to=(pad_x, 0),
                                  **kw)
    cfg = pairhmm.k1_launch(long.xs.shape[1], long.ys.shape[1], rle)
    assert cfg.rows == rows and cfg.stage_x == (pad_x is None)
    for use_lut in (True, False):
        got = pairhmm.forward_total(tc, long, use_lut=use_lut)
        want = pairhmm.forward_total_plain(tc, batch, use_lut=use_lut)
        torch.cuda.synchronize()
        assert got[0].item() == 0.0 and bool(got.isfinite().all())
        if use_lut:
            assert torch.equal(got, want)
        else:
            assert (got - want).abs().max().item() <= 1e-4
        if pad_x is not None:
            assert torch.equal(got, pairhmm.forward_total(tc, batch,
                                                          use_lut=use_lut))


@pytest.mark.cuda
def test_k1_launch_config_matches_kernel():
    """The kernel's own layout has the wrapper's shared-memory bytes, and
    the kernel refuses a launch given less, or a configuration it does not
    take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    lib = pairhmm._k1_lib()
    for lx in (1, 29, 909, 4097, 90_000, 150_000):
        for ly, *_ in K1_LAUNCHES:
            for rle in (False, True):
                cfg = pairhmm.k1_launch(lx, ly, rle)
                assert lib.k1_smem_bytes(lx, rle, cfg.warps,
                                         cfg.stage_x) == cfg.smem
    tc = _port_tables(False, device="cuda")
    pairs, kw = _inputs(6, b=4)
    bt = pairhmm.make_batch(pairs, device="cuda", pad_to=(40, 40), **kw)
    B, Lx = bt.xs.shape
    Ly = bt.ys.shape[1]
    cfg = pairhmm.k1_launch(Lx, Ly, False)
    assert cfg.stage_x and cfg.rows == 1
    unstaged = lib.k1_smem_bytes(Lx, 0, cfg.warps, 0)
    out = torch.empty(B, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = [t.data_ptr() for t in (bt.xs, bt.ys, bt.lxs, bt.lys, bt.strands,
                                   bt.ragged_left, bt.ragged_right)]
    args += [None, None] + [t.data_ptr() for t in (tc.match, tc.gap_x,
                                                   tc.gap_y, tc.trans)]
    args += [None, out.data_ptr(), B, Lx, Ly, 1]

    def launch(warps, rows, stage_x, smem):
        return lib.k1_forward_total(*args, warps, rows, stage_x, smem, stream)
    assert launch(cfg.warps, 1, 1, cfg.smem - 1) != 0
    assert launch(cfg.warps, 1, 1, unstaged) != 0     # X does not fit
    assert launch(cfg.warps - 1, 1, 1, cfg.smem) != 0  # too few lanes
    assert launch(cfg.warps, 3, 1, cfg.smem) != 0      # rows not 1/2/4/8
    want = pairhmm.forward_total_plain(tc, bt, True)
    for stage_x, smem in ((1, cfg.smem), (0, unstaged)):
        out.zero_()
        assert launch(cfg.warps, 1, stage_x, smem) == 0
        torch.cuda.synchronize()
        assert torch.equal(out, want)
