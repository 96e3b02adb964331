"""The port's device forward-backward of the read-partition HMM
(margin_tpu_torch/phase/rphmm_device.py, kernel K6's plain twin on the
CPU) against margin_tpu's (phase/rphmm_device.py, its XLA `_fb_jit` on the
CPU) and both packages' float64 host FB.

Every FB quantity is an integer under maxNotSumTransitions, so all four
must agree bit for bit. The inputs are tests/test_rphmm_device.py's: the
same seeded random references and profile sequences, built into each
package's own classes."""

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
    """K6 stages a column's profile bytes in shared memory beside the
    ancestor's allele sums when both fit, reads them from device memory
    when they do not, and keeps sums that alone overflow shared memory (a
    site of more than 227 alleles) in device memory."""
    sums = 2 * 3 * rphmm_fb.EMISSION_THREADS * 4
    assert rphmm_fb.emission_smem(100, 64, 3, True) == (6400 + sums, True,
                                                        True)
    assert rphmm_fb.emission_smem(100, 64, 3, False) == (6400, True, True)
    assert rphmm_fb.emission_smem(4000, 64, 3, True) == (sums, False, True)
    assert rphmm_fb.emission_smem(4000, 64, 3, False) == (0, False, True)
    # 300 alleles: the sums go to device memory, the profile stays staged
    lay = rphmm_fb.emission_smem(310, 64, 300, True)
    assert lay == (310 * 64, True, False)
    assert not lay.sums_shared and lay.staged
    assert rphmm_fb.emission_smem(310, 64, 300, False) == (310 * 64, True,
                                                           True)
    assert rphmm_fb.emission_smem(4000, 64, 300, True) == (0, False, False)


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
    in device memory: the twin (the device path on the CPU) equals
    margin_tpu's _fb_jit and both host FBs bit for bit."""
    jax_hmms, hmms = _wide_site_hmms(13)
    assert hmms and len(hmms) == len(jax_hmms)
    for jh, th in zip(jax_hmms, hmms):
        pk = rphmm_device.pack(th, "cpu")
        _, _, D, A, _, As, _ = pk.dims
        assert As >= 300
        assert not rphmm_fb.emission_smem(A, D, As, True).sums_shared
        _four_ways(jh, th, True)


def _random_pack(seed, ncol, C, n_sites, M, device):
    """A seeded pack of `ncol` columns of 64 reads over `n_sites` sites of
    2-3 alleles each, random merge maps into `M` slots."""
    rng = np.random.default_rng(seed)
    site_a = rng.integers(2, 4, (ncol, n_sites)).astype(np.int32)
    site_off = (np.cumsum(site_a, axis=1) - site_a).astype(np.int32)
    A = int(site_a.sum(axis=1).max())
    sub = rng.integers(0, 90, (ncol, n_sites, 3, 3)).astype(np.int32)
    prior = rng.integers(0, 30, (ncol, n_sites, 3)).astype(np.int32)
    two = site_a == 2
    sub[two, 2, :] = rphmm_fb.BIG
    sub[two, :, 2] = rphmm_fb.BIG
    prior[two, 2] = 0
    arrays = (
        rng.integers(-(1 << 62), 1 << 62, (ncol, C), dtype=np.int64),
        rng.integers(C // 2, C + 1, ncol).astype(np.int32),
        np.full(ncol, 64, dtype=np.int32),
        np.full(ncol, n_sites, dtype=np.int32),
        rng.integers(0, 64, (ncol, A, 64)).astype(np.uint8),
        site_off, site_a, sub, prior,
        rng.integers(0, M, (ncol, C)).astype(np.int32),
        rng.integers(0, M, (ncol, C)).astype(np.int32))
    return rphmm_fb.RphmmPack(*(torch.from_numpy(a).to(device)
                                for a in arrays), M)


@pytest.mark.cuda
def test_k6_matches_twin_on_a_column_too_wide_to_stage():
    """A column of ~4000 alleles at 64 reads: its profile does not fit in
    shared memory, so K6 reads it from device memory; still the twin's
    values bit for bit, with and without the ancestor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    pk = _random_pack(3, 3, 200, 1600, 150, "cuda")
    _, _, D, A, _, As, _ = pk.dims
    for include_ancestor in (True, False):
        assert not rphmm_fb.emission_smem(A, D, As, include_ancestor)[1]
        got = rphmm_fb.rphmm_fb(pk, include_ancestor)
        want = rphmm_fb.rphmm_fb_plain(pk, include_ancestor)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_k6_matches_twin_on_a_300_allele_site():
    """A site of 300 alleles with the ancestor: K6 keeps its allele sums in
    device memory and still gives the twin's values bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    _, hmms = _wide_site_hmms(13)
    for hmm in hmms:
        pk = rphmm_device.pack(hmm, "cuda")
        _, _, D, A, _, As, _ = pk.dims
        assert not rphmm_fb.emission_smem(A, D, As, True).sums_shared
        got = rphmm_fb.rphmm_fb(pk, True)
        want = rphmm_fb.rphmm_fb_plain(pk, True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
