"""The port's device forward-backward of the read-partition HMM
(margin_tpu_torch/phase/rphmm_device.py, kernel K6's plain twin on the
CPU) against margin_tpu's (phase/rphmm_device.py, its XLA `_fb_jit` on the
CPU) and both packages' float64 host FB.

Every FB quantity is an integer under maxNotSumTransitions, so all four
must agree bit for bit. The inputs are tests/test_rphmm_device.py's: the
same seeded random references and profile sequences, built into each
package's own classes."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from margin_tpu.params import PhaseParams as JaxPhaseParams
from margin_tpu.phase import bubbles as jax_bubbles
from margin_tpu.phase import rphmm_device as jax_device
from margin_tpu.phase.rphmm import get_rp_hmms as jax_get_rp_hmms
from margin_tpu_torch.ops import rphmm_fb
from margin_tpu_torch.params import PhaseParams
from margin_tpu_torch.phase import bubbles, rphmm_device
from margin_tpu_torch.phase.rphmm import get_rp_hmms

torch.set_num_threads(1)


def _random_ref(mod, rng, n_sites, max_alleles=3):
    sites = []
    off = 0
    for _ in range(n_sites):
        a = int(rng.integers(2, max_alleles + 1))
        sites.append(mod.Site(
            a, off,
            rng.integers(0, 30, a).astype(np.uint16),
            rng.integers(0, 90, (a, a)).astype(np.uint16)))
        off += a
    return mod.Reference("t", sites, off)


def _random_pseqs(mod, rng, ref, n_reads, span=None):
    offsets = ref.allele_offsets()
    seqs = []
    for i in range(n_reads):
        if span is None:
            s = int(rng.integers(0, max(1, ref.length - 2)))
            e = int(rng.integers(s + 1, ref.length + 1))
        else:
            s, e = span
        probs = rng.integers(0, 64, int(offsets[e] - offsets[s]))
        seqs.append(mod.ProfileSeq(None, f"r{i}", s, e - s,
                                   int(offsets[s]), probs.astype(np.uint8)))
    return seqs


def _both(seed, n_sites, n_reads, max_alleles=3, span=None, **params):
    """The same seeded inputs as each package's HMMs: (jax hmms, port hmms
    built for the CPU)."""
    out = []
    for mod, pp, get in ((jax_bubbles, JaxPhaseParams, jax_get_rp_hmms),
                         (bubbles, PhaseParams, None)):
        rng = np.random.default_rng(seed)
        ref = _random_ref(mod, rng, n_sites, max_alleles)
        seqs = _random_pseqs(mod, rng, ref, n_reads, span)
        p = pp(maxNotSumTransitions=True, **params)
        out.append(get(seqs, ref, p) if get else
                   get_rp_hmms(seqs, ref, p, "cpu"))
    return out


def _snapshot(hmm):
    out = []
    for c in hmm.columns:
        out.append((np.array(c.emission), np.array(c.forward),
                    np.array(c.backward), c.total_log_prob))
    for m in hmm.merges:
        out.append((np.array(m.forward), np.array(m.backward)))
    out.append((hmm.forward_log_prob, hmm.backward_log_prob))
    return out


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for xa, xb in zip(a, b):
        for va, vb in zip(xa, xb):
            va, vb = np.asarray(va), np.asarray(vb)
            assert va.dtype == vb.dtype
            np.testing.assert_array_equal(va, vb)


def _four_ways(jh, th, include_ancestor):
    """Host FB and device FB of each package on one HMM pair: all equal."""
    jh.forward_backward(include_ancestor=include_ancestor)
    th.forward_backward(include_ancestor=include_ancestor)
    host_j, host_t = _snapshot(jh), _snapshot(th)
    _assert_bitwise(host_t, host_j)
    jax_device.forward_backward_device(jh, include_ancestor=include_ancestor)
    rphmm_device.forward_backward_device(th, include_ancestor, "cpu")
    _assert_bitwise(_snapshot(jh), host_j)
    _assert_bitwise(_snapshot(th), host_t)


@pytest.mark.parametrize("include_ancestor", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_bit_identical_to_jax_and_host(seed, include_ancestor):
    jax_hmms, hmms = _both(seed, 14, 12, minPartitionsInAColumn=4,
                           maxPartitionsInAColumn=16,
                           minPosteriorProbabilityForPartition=0.01)
    assert hmms and len(hmms) == len(jax_hmms)
    for jh, th in zip(jax_hmms, hmms):
        _four_ways(jh, th, include_ancestor)


def test_device_fb_through_prune_cycle(monkeypatch):
    """FB -> prune -> FB with the device path forced (the merge tree's
    cross products included) keeps the tracebacks of the host-only run and
    of margin_tpu's device run."""
    kw = dict(minPartitionsInAColumn=4, maxPartitionsInAColumn=8,
              minPosteriorProbabilityForPartition=0.01)

    def run(mode):
        monkeypatch.setenv("MARGIN_TPU_RPHMM", mode)
        jax_hmms, hmms = _both(7, 20, 16, max_alleles=2, **kw)
        out = []
        for group in (jax_hmms, hmms):
            paths = []
            for hmm in group:
                hmm.forward_backward()
                hmm.prune()
                hmm.forward_backward()
                paths.append(hmm.forward_traceback())
            out.append(paths)
        return out

    jax_dev, port_dev = run("device")
    jax_host, port_host = run("host")
    assert port_dev == port_host == jax_host == jax_dev


def test_device_fb_deep_wide_column():
    """One wide multi-allele column group with 40 reads over every site."""
    jax_hmms, hmms = _both(11, 6, 40, max_alleles=5, span=(0, 6),
                           minPartitionsInAColumn=8,
                           maxPartitionsInAColumn=32,
                           minPosteriorProbabilityForPartition=0.001)
    for jh, th in zip(jax_hmms, hmms):
        _four_ways(jh, th, True)


def test_use_device_fb_policy(monkeypatch):
    """host / device / auto on the CPU and on a CUDA device, the int32
    overflow guard and the logaddexp path, as margin_tpu decides."""
    jax_hmms, hmms = _both(3, 4, 4, minPartitionsInAColumn=4,
                           maxPartitionsInAColumn=8,
                           minPosteriorProbabilityForPartition=0.01)
    hmm = hmms[0]
    monkeypatch.delenv("MARGIN_TPU_RPHMM", raising=False)
    monkeypatch.delenv("MARGIN_TPU_RPHMM_THRESHOLD", raising=False)
    # auto: never on the CPU; on CUDA by the work threshold
    assert not rphmm_device.use_device_fb(hmm, True, "cpu")
    assert not rphmm_device.use_device_fb(hmm, True, "cuda")
    work = rphmm_device.work(hmm)
    monkeypatch.setenv("MARGIN_TPU_RPHMM_THRESHOLD", str(work))
    assert rphmm_device.use_device_fb(hmm, True, "cuda")
    assert not rphmm_device.use_device_fb(hmm, True, "cpu")
    monkeypatch.setenv("MARGIN_TPU_RPHMM_THRESHOLD", str(work + 1))
    assert not rphmm_device.use_device_fb(hmm, True, "cuda")
    # forced
    monkeypatch.setenv("MARGIN_TPU_RPHMM", "device")
    assert rphmm_device.use_device_fb(hmm, True, "cpu")
    monkeypatch.setenv("MARGIN_TPU_RPHMM", "host")
    monkeypatch.setenv("MARGIN_TPU_RPHMM_THRESHOLD", "0")
    assert not rphmm_device.use_device_fb(hmm, True, "cuda")
    # the overflow guard and the logaddexp path win over "device"
    monkeypatch.setenv("MARGIN_TPU_RPHMM", "device")
    cols = hmm.columns
    saved = [c.length for c in cols]
    cols[0].length = (1 << 30) // rphmm_device._PER_SITE_BOUND + 1
    assert not rphmm_device.use_device_fb(hmm, True, "cpu")
    for c, n in zip(cols, saved):
        c.length = n
    assert rphmm_device.use_device_fb(hmm, True, "cpu")
    hmm.params.maxNotSumTransitions = False
    assert not rphmm_device.use_device_fb(hmm, True, "cpu")
    # margin_tpu's policy answers the same where both can be asked
    jax_hmms[0].params.maxNotSumTransitions = False
    assert not jax_device.use_device_fb(jax_hmms[0], True)


def test_forward_backward_hook_follows_the_hmm_device(monkeypatch):
    """RPHmm.forward_backward takes the device path with the device its
    HMM was built for: forced on, a CPU HMM runs K6's twin (counted by no
    launch) and equals the host FB."""
    _, hmms = _both(1, 10, 10, minPartitionsInAColumn=4,
                    maxPartitionsInAColumn=16,
                    minPosteriorProbabilityForPartition=0.01)
    hmm = hmms[0]
    assert hmm.device == "cpu"
    monkeypatch.setenv("MARGIN_TPU_RPHMM", "host")
    hmm.forward_backward()
    host = _snapshot(hmm)
    calls = []
    real = rphmm_device.forward_backward_device
    monkeypatch.setattr(rphmm_device, "forward_backward_device",
                        lambda *a: calls.append(a[2]) or real(*a))
    monkeypatch.setenv("MARGIN_TPU_RPHMM", "device")
    launches = rphmm_fb.RPHMM_FB.launches
    hmm.forward_backward()
    assert calls == ["cpu"]
    assert rphmm_fb.RPHMM_FB.launches == launches
    _assert_bitwise(_snapshot(hmm), host)


def test_pack_layout():
    """The pack pads D to a multiple of 4 and keeps each column's cells,
    sites and merge maps where K6 reads them."""
    _, hmms = _both(2, 14, 12, minPartitionsInAColumn=4,
                    maxPartitionsInAColumn=16,
                    minPosteriorProbabilityForPartition=0.01)
    hmm = hmms[0]
    pk = rphmm_device.pack(hmm, "cpu")
    ncol, C, D, A, S, As, M = pk.dims
    assert ncol == len(hmm.columns) and D % 4 == 0
    assert C == max(len(c.partitions) for c in hmm.columns)
    assert M == max([m.size() for m in hmm.merges] + [1])
    for ci, col in enumerate(hmm.columns):
        n = len(col.partitions)
        assert pk.n_cells[ci] == n and pk.depth[ci] == col.depth
        assert pk.n_sites[ci] == col.length
        got = pk.parts[ci, :n].numpy().view(np.uint64)
        np.testing.assert_array_equal(got, np.array(col.partitions,
                                                    dtype=np.uint64))
        assert not pk.parts[ci, n:].any()
    assert int(pk.sub.max()) == rphmm_fb.BIG


def _pack_loop(hmm):
    """The per-column loop that built the pack before it was made of whole
    arrays: the reference the pack must equal array for array (on the
    CPU)."""
    cols, merges = hmm.columns, hmm.merges
    ncol = len(cols)
    offsets = hmm.ref.allele_offsets()
    sites = hmm.ref.sites
    C = max(len(c.partitions) for c in cols)
    D = -(-max(1, max(c.depth for c in cols)) // 4) * 4
    a_list = [int(offsets[c.ref_start + c.length] - offsets[c.ref_start])
              for c in cols]
    A = max(1, max(a_list))
    S = max(1, max(c.length for c in cols))
    As = max([sites[s].allele_number for c in cols
              for s in range(c.ref_start, c.ref_start + c.length)] + [2])
    M = max([m.size() for m in merges] + [1])
    parts = np.zeros((ncol, C), dtype=np.int64)
    n_cells = np.zeros(ncol, dtype=np.int32)
    depth = np.zeros(ncol, dtype=np.int32)
    n_sites = np.zeros(ncol, dtype=np.int32)
    pt = np.zeros((ncol, A, D), dtype=np.uint8)
    site_off = np.zeros((ncol, S), dtype=np.int32)
    site_a = np.zeros((ncol, S), dtype=np.int32)
    sub = np.full((ncol, S, As, As), rphmm_fb.BIG, dtype=np.int32)
    prior = np.zeros((ncol, S, As), dtype=np.int32)
    idx_prev = np.zeros((ncol, C), dtype=np.int32)
    idx_next = np.zeros((ncol, C), dtype=np.int32)
    for ci, col in enumerate(cols):
        p64 = np.array(col.partitions, dtype=np.uint64)
        n = len(p64)
        parts[ci, :n] = p64.view(np.int64)
        n_cells[ci] = n
        depth[ci] = col.depth
        n_sites[ci] = col.length
        a0 = int(offsets[col.ref_start])
        for i, ps in enumerate(col.seqs):
            pt[ci, :a_list[ci], i] = ps.probs[
                a0 - ps.allele_offset:a0 - ps.allele_offset + a_list[ci]]
        for sj, s in enumerate(range(col.ref_start,
                                     col.ref_start + col.length)):
            site = sites[s]
            na = site.allele_number
            site_off[ci, sj] = site.allele_offset - a0
            site_a[ci, sj] = na
            sub[ci, sj, :na, :na] = site.substitution_log_probs
            prior[ci, sj, :na] = site.allele_prior_log_probs
        if ci > 0:
            idx_prev[ci, :n] = merges[ci - 1].prev_idx_array(p64)
        if ci < len(merges):
            idx_next[ci, :n] = merges[ci].next_idx_array(p64)
    return rphmm_fb.RphmmPack(*(torch.from_numpy(a) for a in (
        parts, n_cells, depth, n_sites, pt, site_off, site_a, sub, prior,
        idx_prev, idx_next)), M)


def _cross_product(seed, n_sites, n_reads, span):
    """The cross product of two seeded read sets' tiling paths of most
    work, as merge_two_tiling_paths builds it (chip_smoke.py's HMM of work
    >= 10M at a CPU size)."""
    from margin_tpu_torch.phase import rphmm
    rng = np.random.default_rng(seed)
    ref = _random_ref(bubbles, rng, n_sites)
    seqs = _random_pseqs(bubbles, rng, ref, n_reads)
    offsets = ref.allele_offsets()
    for i, ps in enumerate(seqs):
        n = int(rng.integers(span[0], span[1]))
        s = int(rng.integers(0, n_sites - n))
        probs = rng.integers(0, 64, int(offsets[s + n] - offsets[s]))
        seqs[i] = bubbles.ProfileSeq(None, f"r{i}", s, n, int(offsets[s]),
                                     probs.astype(np.uint8))
    params = PhaseParams()
    tp1 = get_rp_hmms(seqs[0::2], ref, params, "cpu")
    tp2 = get_rp_hmms(seqs[1::2], ref, params, "cpu")
    crosses = []
    for comp in rphmm.get_overlapping_components(tp1, tp2):
        sub = rphmm.get_tiling_paths(comp)
        if len(sub) == 2:
            h1 = rphmm.fuse_tiling_path(sub[0])
            h2 = rphmm.fuse_tiling_path(sub[1])
            rphmm.RPHmm.align_columns(h1, h2)
            crosses.append(rphmm.RPHmm.cross_product(h1, h2))
    return max(crosses, key=rphmm_device.work)


def _pack_cases():
    kw = dict(minPartitionsInAColumn=4, maxPartitionsInAColumn=16,
              minPosteriorProbabilityForPartition=0.01)
    for seed in (0, 1, 2):
        for hmm in _both(seed, 14, 12, **kw)[1]:
            yield f"seed {seed}", hmm
    yield "deep wide column", _both(11, 6, 40, max_alleles=5, span=(0, 6),
                                    minPartitionsInAColumn=8,
                                    maxPartitionsInAColumn=32,
                                    minPosteriorProbabilityForPartition=0.001
                                    )[1][0]
    yield "cross product", _cross_product(31, 80, 40, (15, 40))
    hmm = _both(7, 20, 16, max_alleles=2, minPartitionsInAColumn=4,
                maxPartitionsInAColumn=8,
                minPosteriorProbabilityForPartition=0.01)[1][0]
    hmm.forward_backward()
    hmm.prune()
    yield "pruned", hmm
    for hmm in _wide_site_hmms(13)[1]:
        yield "300-allele site", hmm


def test_pack_equals_the_column_loop(monkeypatch):
    """The whole-array pack gives the per-column loop's arrays, array for
    array (dtype, shape, values), on the seeded HMMs, a deep wide column, a
    cross product, a pruned HMM and the 300-allele reference."""
    monkeypatch.setenv("MARGIN_TPU_RPHMM", "host")
    labels = []
    for label, hmm in _pack_cases():
        want = _pack_loop(hmm)
        got = rphmm_device.pack(hmm, "cpu")
        assert got.M == want.M, label
        for name in ("parts", "n_cells", "depth", "n_sites", "pt",
                     "site_off", "site_a", "sub", "prior", "idx_prev",
                     "idx_next"):
            g, w = getattr(got, name), getattr(want, name)
            assert g.dtype == w.dtype and g.shape == w.shape, (label, name)
            assert torch.equal(g, w), (label, name)
        labels.append(label)
    assert {"cross product", "pruned", "300-allele site"} <= set(labels)


def test_phase_without_the_native_engine_on_the_device_fb(tmp_path,
                                                         monkeypatch):
    """run_phase(device="cpu") with the native merge-tree engine absent and
    MARGIN_TPU_RPHMM=device: every read-partition FB of the Python merge
    tree takes the device path (K6's twin here) and the outputs equal the
    native engine's run byte for byte."""
    from margin_tpu_torch.params import Params
    from margin_tpu_torch.phase import native_rp
    from margin_tpu_torch.phase.driver import run_phase
    from margin_tpu_torch.testing.synth import SynthConfig, write_dataset
    ds = write_dataset(str(tmp_path), SynthConfig(
        contig_len=12_000, coverage=10.0, read_len=(2000, 5000), n_snv=10,
        n_sv=0, seed=5))

    def run(out):
        run_phase(ds.bam, ds.fasta, ds.vcf, Params.load(ds.params),
                  str(tmp_path / out), use_lut=True, device="cpu",
                  log=lambda *a: None)
    run("native")
    calls = []
    real = rphmm_device.forward_backward_device
    monkeypatch.setattr(native_rp, "phase_fused_hmm", lambda *a: None)
    monkeypatch.setattr(rphmm_device, "forward_backward_device",
                        lambda *a: calls.append(a[2]) or real(*a))
    monkeypatch.setenv("MARGIN_TPU_RPHMM", "device")
    run("device")
    assert calls and set(calls) == {torch.device("cpu")}
    for ext in ("phased.vcf", "phaseset.bed"):
        with open(tmp_path / f"native.{ext}", "rb") as a, \
                open(tmp_path / f"device.{ext}", "rb") as b:
            assert a.read() == b.read(), ext


@pytest.mark.cuda
def test_k6_matches_twin_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    for seed, include_ancestor in ((0, True), (1, False), (2, True)):
        _, hmms = _both(seed, 14, 12, minPartitionsInAColumn=4,
                        maxPartitionsInAColumn=16,
                        minPosteriorProbabilityForPartition=0.01)
        for hmm in hmms:
            pk = rphmm_device.pack(hmm, "cuda")
            launches = rphmm_fb.RPHMM_FB.launches
            got = rphmm_fb.rphmm_fb(pk, include_ancestor)
            assert rphmm_fb.RPHMM_FB.launches == launches + 1
            want = rphmm_fb.rphmm_fb_plain(pk, include_ancestor)
            for g, w in zip(got, want):
                assert torch.equal(g, w)


def test_emission_smem_stages_the_profile_when_it_fits():
    """K6 builds a column's bit planes (68 bytes an allele) and, with the
    ancestor, stages its sites' substitutions and priors in shared memory
    in one chunk when they fit, and in chunks of whole sites when they do
    not (~4000 alleles at 64 reads); without the ancestor nothing is
    staged but the planes."""
    pb = rphmm_fb.PLANE_BYTES
    lay = rphmm_fb.k6_launch(300, 100, 64, 3, 40, 150, True)
    assert (lay.cap_a, lay.cap_s, lay.stage_sub) == (100, 40, True)
    assert lay.emission_bytes == 100 * pb + 40 * (9 + 3) * 4
    lay = rphmm_fb.k6_launch(300, 100, 64, 3, 40, 150, False)
    assert (lay.cap_a, lay.cap_s, lay.stage_sub) == (100, 40, False)
    assert lay.emission_bytes == 100 * pb
    for ancestor in (True, False):
        lay = rphmm_fb.k6_launch(200, 4000, 64, 3, 1600, 150, ancestor)
        assert 3 <= lay.cap_a < 4000 and lay.emission_bytes <= 232_448
        assert lay.emission_bytes == (lay.cap_a * pb + lay.stage_sub
                                      * lay.cap_s * 48)
    # a site that fits alone always fits a chunk
    lay = rphmm_fb.k6_launch(10, 3400, 64, 3000, 3, 10, False)
    assert lay.cap_a >= 3000


@pytest.mark.parametrize("As, nr, sums, threads", [
    (2, 4, "registers", 128), (4, 4, "registers", 128),
    (5, 16, "registers", 128), (16, 16, "registers", 128),
    (17, 16, "shared", 128), (212, 16, "shared", 128),
    (213, 16, "shared", 64), (400, 16, "shared", 64),
    (401, 16, "shared", 32), (717, 16, "shared", 32),
    (718, 16, "device", 128)])
def test_k6_launch_places_the_ancestor_sums(As, nr, sums, threads):
    """With the ancestor a site's allele sums stay in registers up to the
    bucket of 4 or 16 alleles; a wider site keeps 2 x As ints a thread in
    shared memory at the most threads of 128, 64, 32 that fit beside its
    planes (up to 717 alleles), else in device memory. Without the
    ancestor no sums are kept."""
    lay = rphmm_fb.k6_launch(1000, As + 5, 64, As, 3, 150, True)
    assert (lay.nr, lay.sums, lay.threads) == (nr, sums, threads)
    assert lay.tiles == -(-1000 // threads)
    assert lay.stage_sub == (sums == "registers")
    shared = 2 * As * threads * 4 if sums == "shared" else 0
    assert lay.emission_bytes <= 232_448
    assert lay.emission_bytes - shared == (
        lay.cap_a * rphmm_fb.PLANE_BYTES
        + lay.stage_sub * lay.cap_s * (As * As + As) * 4)
    plain = rphmm_fb.k6_launch(1000, As + 5, 64, As, 3, 150, False)
    assert (plain.sums, plain.threads, plain.stage_sub) == ("registers", 128,
                                                           False)


@pytest.mark.parametrize("M, carry", [(1, "shared"), (19_370, "shared"),
                                      (19_371, "device"),
                                      (40_000, "device")])
def test_k6_launch_places_the_carry(M, carry):
    """The chain keeps three merge rows a sweep in shared memory while
    3 x M ints fit in 232,448 bytes, else its rows are m_fwd / m_bwd in
    device memory."""
    lay = rphmm_fb.k6_launch(2500, 26, 64, 3, 10, M, True)
    assert lay.carry == carry
    assert lay.chain_bytes == (3 * M * 4 if carry == "shared" else 0)
    assert lay.chain_bytes <= 232_448


@pytest.mark.parametrize("C, cpt, threads", [
    (1, 1, 32), (1000, 1, 1024), (1025, 2, 544), (2500, 4, 640),
    (4096, 4, 1024), (4097, 0, 1024)])
def test_k6_launch_splits_the_chain_cells(C, cpt, threads):
    """The chain's block holds a column's cells CPT a thread (1, 2 or 4,
    the fewest that fit 1024 threads; threads a multiple of 32), and loads
    them where used beyond 4096 cells."""
    lay = rphmm_fb.k6_launch(C, 26, 64, 3, 10, 100, False)
    assert (lay.chain_cpt, lay.chain_threads) == (cpt, threads)
    assert not cpt or cpt * threads >= C


def test_k6_launch_refuses_more_than_64_reads():
    """A partition is 64 bits: K6 takes no column of more reads."""
    rphmm_fb.k6_launch(10, 5, 64, 2, 2, 10, True)
    with pytest.raises(ValueError, match="64"):
        rphmm_fb.k6_launch(10, 5, 68, 2, 2, 10, True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitplane_sums_equal_the_twin_matmul(seed):
    """The plain model of K6's bit-plane sums equals the twin's matmul
    sums on seeded packs of 64 reads whose partitions have bit 63 set
    (negative as int64), including all-ones and bit 63 alone."""
    pk = _random_pack(seed, 3, 100, 4, 50, "cpu", full_range=True)
    assert bool((pk.parts < 0).any())
    pk.parts[0, 0] = -1
    pk.parts[0, 1] = -(1 << 63)
    for ci in range(pk.parts.shape[0]):
        want = rphmm_fb.matmul_sums(pk.parts[ci], pk.pt[ci])
        got = rphmm_fb.bitplane_sums(pk.parts[ci], pk.pt[ci])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def _wide_site_hmms(seed, n_reads=10, wide=300):
    """Each package's HMMs over a reference of four sites, the second of
    `wide` alleles, and n_reads profile sequences over all of them."""
    out = []
    for mod, pp, get in ((jax_bubbles, JaxPhaseParams, jax_get_rp_hmms),
                         (bubbles, PhaseParams, None)):
        rng = np.random.default_rng(seed)
        sites, off = [], 0
        for a in (2, wide, 3, 2):
            sites.append(mod.Site(
                a, off, rng.integers(0, 30, a).astype(np.uint16),
                rng.integers(0, 90, (a, a)).astype(np.uint16)))
            off += a
        ref = mod.Reference("t", sites, off)
        seqs = _random_pseqs(mod, rng, ref, n_reads, span=(0, 4))
        p = pp(maxNotSumTransitions=True, minPartitionsInAColumn=4,
               maxPartitionsInAColumn=8,
               minPosteriorProbabilityForPartition=0.01)
        out.append(get(seqs, ref, p) if get else
                   get_rp_hmms(seqs, ref, p, "cpu"))
    return out


def test_twin_on_a_300_allele_site_matches_jax():
    """A site of 300 alleles with the ancestor, whose allele sums K6 keeps
    in shared memory at 64 threads a block (beyond the register bucket):
    the twin (the device path on the CPU) equals margin_tpu's _fb_jit and
    both host FBs bit for bit."""
    jax_hmms, hmms = _wide_site_hmms(13)
    assert hmms and len(hmms) == len(jax_hmms)
    for jh, th in zip(jax_hmms, hmms):
        pk = rphmm_device.pack(th, "cpu")
        _, C, D, A, S, As, M = pk.dims
        assert As >= 300
        lay = rphmm_fb.k6_launch(C, A, D, As, S, M, True)
        assert (lay.sums, lay.threads) == ("shared", 64)
        _four_ways(jh, th, True)


def _random_pack(seed, ncol, C, n_sites, M, device, full_range=False):
    """chip_smoke.random_pack: a seeded pack of `ncol` columns of 64 reads
    over `n_sites` sites of 2-3 alleles each, random merge maps into `M`
    slots; partitions over all 64 bits with `full_range`, else below 2**62
    in magnitude."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke.random_pack(device, seed, ncol, C, n_sites, M,
                                  full_range)


def _k6_against_twin(pk, include_ancestor):
    launches = rphmm_fb.RPHMM_FB.launches
    got = rphmm_fb.rphmm_fb(pk, include_ancestor)
    torch.cuda.synchronize()
    assert rphmm_fb.RPHMM_FB.launches == launches + 1
    want = rphmm_fb.rphmm_fb_plain(pk, include_ancestor)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _layout(pk, include_ancestor):
    _, C, D, A, S, As, M = pk.dims
    return rphmm_fb.k6_launch(C, A, D, As, S, M, include_ancestor)


@pytest.mark.cuda
def test_k6_matches_twin_on_a_column_too_wide_to_stage():
    """A column of ~4000 alleles at 64 reads: its planes do not fit in
    shared memory at once, so K6 builds them in chunks of whole sites;
    still the twin's values bit for bit, with and without the ancestor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    pk = _random_pack(3, 3, 200, 1600, 150, "cuda")
    for include_ancestor in (True, False):
        assert _layout(pk, include_ancestor).cap_a < pk.dims[3]
        _k6_against_twin(pk, include_ancestor)


@pytest.mark.cuda
def test_k6_matches_twin_on_a_300_allele_site():
    """A site of 300 alleles with the ancestor: K6 keeps its allele sums in
    shared memory at 64 threads a block and still gives the twin's values
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    _, hmms = _wide_site_hmms(13)
    for hmm in hmms:
        pk = rphmm_device.pack(hmm, "cuda")
        assert _layout(pk, True).sums == "shared"
        _k6_against_twin(pk, True)


@pytest.mark.cuda
def test_k6_matches_twin_on_an_800_allele_site():
    """A site of 800 alleles with the ancestor: its sums fit no shared
    layout, so K6 keeps them in device memory; the twin's values bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    _, hmms = _wide_site_hmms(17, wide=800)
    for hmm in hmms:
        pk = rphmm_device.pack(hmm, "cuda")
        assert _layout(pk, True).sums == "device"
        _k6_against_twin(pk, True)


@pytest.mark.cuda
def test_k6_matches_twin_on_merge_rows_past_the_shared_carry():
    """Merge rows of 20,000 slots (3 x M ints beyond shared memory): the
    chain keeps them in device memory, on columns of 2500 cells (four a
    thread) and of 5000 (inputs loaded where used). The twin's values bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    for C, cpt in ((2500, 4), (5000, 0)):
        pk = _random_pack(5, 6, C, 4, 20_000, "cuda")
        lay = _layout(pk, False)
        assert (lay.carry, lay.chain_cpt) == ("device", cpt)
        for include_ancestor in (True, False):
            _k6_against_twin(pk, include_ancestor)


@pytest.mark.cuda
def test_k6_matches_twin_on_register_bucket_sites():
    """Sites of 2-3 alleles (the bucket of 4) and of up to 16 alleles (the
    bucket of 16) with the ancestor, their sums in registers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    pk = _random_pack(6, 4, 300, 5, 200, "cuda")
    assert _layout(pk, True).nr == 4
    _k6_against_twin(pk, True)
    _, hmms = _both(8, 8, 14, max_alleles=16, minPartitionsInAColumn=4,
                    maxPartitionsInAColumn=32,
                    minPosteriorProbabilityForPartition=0.001)
    for hmm in hmms:
        pk = rphmm_device.pack(hmm, "cuda")
        lay = _layout(pk, True)
        assert lay.sums == "registers" and lay.stage_sub
        _k6_against_twin(pk, True)


@pytest.mark.cuda
def test_k6_matches_twin_with_bit_63_and_split_columns():
    """64 reads with partitions over all 64 bits (bit 63 set, negative as
    int64) on columns of 1000 cells, each split over eight emission
    blocks, with and without the ancestor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    pk = _random_pack(7, 5, 1000, 6, 400, "cuda", full_range=True)
    assert bool((pk.parts < 0).any())
    assert _layout(pk, True).tiles == 8
    for include_ancestor in (True, False):
        _k6_against_twin(pk, include_ancestor)


@pytest.mark.cuda
def test_k6_layout_mirror_matches_the_kernel():
    """k6_launch's byte counts equal the kernel's own (k6_emission_bytes,
    k6_chain_bytes) at each place of the sums and the carry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    lib = rphmm_fb._k6()
    for C, A, As, S, M, anc in ((2500, 26, 3, 10, 2500, True),
                                (2500, 26, 3, 10, 2500, False),
                                (256, 305, 300, 3, 150, True),
                                (256, 810, 800, 3, 150, True),
                                (200, 4000, 3, 1600, 30_000, True)):
        lay = rphmm_fb.k6_launch(C, A, 64, As, S, M, anc)
        assert lay.emission_bytes == lib.k6_emission_bytes(
            lay.cap_a, lay.cap_s, As, lay.threads, int(lay.stage_sub),
            rphmm_fb._SUMS[lay.sums])
        assert lay.chain_bytes == lib.k6_chain_bytes(
            M, rphmm_fb._CARRY[lay.carry])
