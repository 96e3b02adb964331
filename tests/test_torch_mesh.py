"""The port's multi-device scoring context (margin_tpu_torch.parallel.mesh
and the mesh half of parallel/executor.py) and its entry points
(margin_tpu_torch.entry) against the JAX package.

The JAX side runs on tests/conftest.py's 8 virtual CPU devices; the port's
mesh on a device list with repeats ([cpu] * 8, [cpu] * 4, [cpu] * 2), which
runs every split, pad, per-shard call, gather and reduce on the CPU, where
K1's plain twin stands in for the kernel. The LUT scores are held to
margin_tpu's bit for bit in a subprocess with XLA's FMA contraction off
(see tests/test_torch_pairhmm.py); the exact logAdd within atol 2e-3, the
slot sums within rtol 1e-6. A phase run and a diploid polish run over a
mesh must write what the runs without one write, byte for byte.
"""

import filecmp
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
import __graft_entry__ as graft  # noqa: E402
from margin_tpu.ops import pairhmm as jpairhmm  # noqa: E402
from margin_tpu.parallel import executor as jexecutor  # noqa: E402
from margin_tpu.parallel import mesh as jmesh  # noqa: E402
from margin_tpu_torch import entry  # noqa: E402
from margin_tpu_torch.ops import pairhmm  # noqa: E402
from margin_tpu_torch.params import Params  # noqa: E402
from margin_tpu_torch.parallel import executor, ipc  # noqa: E402
from margin_tpu_torch.parallel import mesh as meshmod  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def no_mesh_left():
    """Every test starts and ends with the plain context."""
    executor.disable_mesh()
    yield
    executor.disable_mesh()


def _port_example(n, lx, ly):
    return entry._example_tables_and_batch(n, lx, ly, device="cpu")


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_shape_matches_jax(n):
    port = meshmod.make_mesh(n, devices=[CPU] * 8)
    want = jmesh.make_mesh(n).devices.shape
    assert port.devices.shape == want
    assert port.axis_names == ("dp", "sp") and port.size == n
    assert port.shape == dict(zip(("dp", "sp"), want))


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meshmod.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meshmod.make_mesh(2)


def _ragged_pairs(seed, n, rle):
    rng = np.random.default_rng(seed)
    pairs, reps = [], []
    for _ in range(n):
        lx, ly = rng.integers(0, 14, 2)
        pairs.append((rng.integers(0, 5, lx).astype(np.uint8),
                      rng.integers(0, 4, ly).astype(np.uint8)))
        reps.append((rng.integers(1, 60, lx), rng.integers(1, 60, ly)))
    return pairs, dict(strands=rng.integers(0, 2, n),
                       ragged_left=rng.random(n) < 0.3,
                       ragged_right=rng.random(n) < 0.3,
                       rep_pairs=reps if rle else None)


@pytest.mark.parametrize("rle", [False, True])
def test_shard_batch_rows_match_jax(rle):
    """Shard k holds the rows JAX's shard_batch puts on mesh device k,
    pad lanes (61 pairs padded to 64 by pad_batch's fills) included."""
    pairs, kw = _ragged_pairs(9, 61, rle)
    mesh = meshmod.make_mesh(8, devices=[CPU] * 8)
    shards = meshmod.shard_batch(pairhmm.make_batch(pairs, device="cpu",
                                                    **kw), mesh)
    jm = jmesh.make_mesh(8)
    jb = jexecutor.pad_batch(jpairhmm.make_batch(pairs, bucket=False, **kw),
                             8)
    jsh = jmesh.shard_batch(jb, jm)
    assert len(shards) == 8
    for f in meshmod._FIELDS:
        arr = getattr(jsh, f)
        if arr is None:
            assert getattr(shards[0], f) is None
            continue
        by_dev = {s.device: np.asarray(s.data) for s in
                  arr.addressable_shards}
        for k, dev in enumerate(jm.devices.flat):
            got = getattr(shards[k], f).numpy()
            assert np.array_equal(got, by_dev[dev]), (f, k)


def test_mesh_scores_bit_identical_to_one_device():
    """49 pairs of 9 x 11 over [cpu] * 8: 7 pad lanes, the last shard all
    pad; scores equal the one-device path's bit for bit, both logAdds."""
    tables, batch = _port_example(49, 9, 11)
    single = {lut: executor.score_batch(tables, batch, use_lut=lut)
              for lut in (True, False)}
    assert executor.enable_mesh(devices=[CPU] * 8)
    assert executor.context().n_shards == 8
    for lut in (True, False):
        got = executor.score_batch(tables, batch, use_lut=lut)
        assert got.shape == (49,) and got.dtype == np.float32
        assert np.array_equal(got, single[lut])


def test_device_stats_count_padded_cells():
    tables, batch = _port_example(49, 9, 11)
    executor.enable_mesh(devices=[CPU] * 8)
    executor.DEVICE_STATS.reset()
    executor.score_batch(tables, batch)
    snap = executor.DEVICE_STATS.snapshot()
    assert (snap["launches"], snap["pairs"]) == (1, 56)
    assert snap["cells"] == 56 * (9 + 11) * (11 + 1)


def jax_mesh_scores_without_fma(out_path):
    """Subprocess body: margin_tpu's enable_mesh(8) score_batch on 49
    pairs of 9 x 11, LUT logAdd, with XLA's FMA contraction off."""
    tables, batch = graft._example_tables_and_batch(n_pairs=49, lx=9,
                                                    ly=11)
    assert jexecutor.enable_mesh(8)
    out = jexecutor.score_batch(tables, batch, use_lut=True)[:49]
    np.save(out_path, np.asarray(out, np.float32))


@pytest.fixture(scope="module")
def no_fma_mesh_scores(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "scores.npy")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2 "
                         "--xla_force_host_platform_device_count=8")
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import jax; jax.config.update('jax_platforms', 'cpu')\n"
            "import test_torch_mesh as T\n"
            "T.jax_mesh_scores_without_fma(%r)\n" % (HERE, ROOT, path))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=300)
    return np.load(path)


def test_mesh_scores_lut_bit_identical_to_jax(no_fma_mesh_scores):
    tables, batch = _port_example(49, 9, 11)
    executor.enable_mesh(devices=[CPU] * 8)
    got = executor.score_batch(tables, batch, use_lut=True)
    assert np.array_equal(got, no_fma_mesh_scores), \
        np.abs(got - no_fma_mesh_scores).max()


def test_mesh_scores_exact_within_tolerance_of_jax():
    tables, batch = _port_example(49, 9, 11)
    executor.enable_mesh(devices=[CPU] * 8)
    got = executor.score_batch(tables, batch)
    jt, jb = graft._example_tables_and_batch(n_pairs=49, lx=9, ly=11)
    try:
        assert jexecutor.enable_mesh(8)
        want = jexecutor.score_batch(jt, jb)[:49]
    finally:
        jexecutor.disable_mesh()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def _host_sums(scores, n_slots):
    out = np.zeros(n_slots)
    for i, s in enumerate(scores):
        out[i % n_slots] += float(s)
    return out


@pytest.mark.parametrize("n_pairs,n_slots", [(49, 3), (64, 4)])
def test_score_slot_sums_match_jax(n_pairs, n_slots):
    tables, batch = _port_example(n_pairs, 10, 12)
    slots = np.arange(n_pairs) % n_slots
    one_scores, one_sums = executor.score_slot_sums(tables, batch, slots,
                                                    n_slots)
    executor.enable_mesh(devices=[CPU] * 8)
    scores, sums = executor.score_slot_sums(tables, batch, slots, n_slots)
    assert np.array_equal(scores, one_scores)
    jt, jb = graft._example_tables_and_batch(n_pairs=n_pairs, lx=10, ly=12)
    try:
        jexecutor.enable_mesh(8)
        _, jsums = jexecutor.score_slot_sums(jt, jb, np.arange(
            jb.xs.shape[0]) % n_slots, n_slots)
    finally:
        jexecutor.disable_mesh()
    host = _host_sums(one_scores, n_slots)
    for got in (sums, one_sums):
        assert got.shape == (n_slots,) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(jsums), rtol=1e-6)
        np.testing.assert_allclose(got, host, rtol=1e-6)


def test_phase_step_sharded_matches_jax():
    """phase_step_sharded(make_mesh(8), 4) on 64 pairs of 10 x 12 against
    margin_tpu's on its 8-device mesh (test_entry_and_mesh.py:31-53)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    tables, batch = _port_example(64, 10, 12)
    mesh = meshmod.make_mesh(8, devices=[CPU] * 8)
    step = meshmod.phase_step_sharded(mesh, 4)
    scores, sums = step(tables, meshmod.shard_batch(batch, mesh),
                        np.arange(64) % 4)
    assert scores.shape == (64,) and sums.shape == (4,)
    assert torch.equal(scores, pairhmm.forward_total(tables, batch))
    jt, jb = graft._example_tables_and_batch(n_pairs=64, lx=10, ly=12)
    jm = jmesh.make_mesh(8)
    jscores, jsums = jmesh.phase_step_sharded(jm, 4)(
        jt, jmesh.shard_batch(jb, jm),
        jax.device_put(jnp.arange(64, dtype=jnp.int32) % 4,
                       NamedSharding(jm, P(("dp", "sp")))))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores)[:64],
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-6)
    np.testing.assert_allclose(sums.numpy(), _host_sums(scores.numpy(), 4),
                               rtol=1e-6)


def test_tables_replicated_once_per_device():
    tables, _ = _port_example(1, 3, 3)
    reps = meshmod.Replicas()
    assert reps.on(tables, CPU) is tables
    meta = torch.device("meta")
    first = reps.on(tables, meta)
    assert first.device == meta and first is reps.on(tables, meta)
    assert reps.on(pairhmm.PairHmmTables(*(t.clone() for t in (
        tables.match, tables.gap_x, tables.gap_y, tables.trans))),
        meta) is not first


def _requests():
    rng = np.random.default_rng(7)

    def make_request(seed, n):
        r = np.random.default_rng(seed)
        pairs = [(r.integers(0, 4, int(r.integers(3, 24))).astype(np.uint8),
                  r.integers(0, 4, int(r.integers(3, 28))).astype(np.uint8))
                 for _ in range(n)]
        return pairs, [int(s) for s in r.integers(0, 2, n)]
    return [make_request(100 + i, int(rng.integers(5, 40)))
            for i in range(12)]


def _sequential(tables, reqs):
    return [pairhmm.forward_total(tables, pairhmm.make_batch(
        pairs, strands=np.asarray(strands, np.int32), device="cpu")).numpy()
        for pairs, strands in reqs]


def test_concurrent_score_pairs_under_mesh_match_sequential():
    """test_entry_and_mesh.py:56-95 under a [cpu] * 4 mesh: concurrent
    score_pairs calls, merged into shared sharded batches, return the
    sequential scores bit for bit, in request order."""
    tables, _ = _port_example(1, 3, 3)
    reqs = _requests()
    expected = _sequential(tables, reqs)
    executor.enable_mesh(devices=[CPU] * 4)
    executor.DEVICE_STATS.reset()
    with ThreadPoolExecutor(max_workers=6) as pool:
        outs = list(pool.map(lambda pr: executor.score_pairs(
            tables, pr[0], pr[1], batch_max=64), reqs))
    for got, want in zip(outs, expected):
        np.testing.assert_array_equal(got, want)
    assert executor.DEVICE_STATS.snapshot()["pairs"] % 4 == 0
    assert executor.score_pairs(tables, [], []).shape == (0,)


def test_score_server_spreads_workers_over_the_mesh():
    """A parent with a mesh scores its process workers' requests through
    it: two clients on their own threads, as two workers would call."""
    tables, _ = _port_example(1, 3, 3)
    reqs = _requests()
    expected = _sequential(tables, reqs)
    executor.enable_mesh(devices=[CPU] * 4)
    server = ipc.ScoreServer(CPU)
    clients = [ipc.ScoreClient(server.address, server.authkey)
               for _ in range(2)]
    outs = [None] * len(reqs)

    def work(c):
        for i in range(c, len(reqs), 2):
            outs[i] = clients[c].score(tables, reqs[i][0], reqs[i][1], None,
                                       False, 64)
    try:
        threads = [threading.Thread(target=work, args=(c,)) for c in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        server.close()
    for got, want in zip(outs, expected):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def phase_set(tmp_path_factory):
    return entry._default_phase_set(str(tmp_path_factory.mktemp("mphase")))


@pytest.fixture(scope="module")
def diploid_set(tmp_path_factory):
    return entry._default_diploid_set(str(tmp_path_factory.mktemp("mdip")))


def test_phase_on_mesh_byte_identical(phase_set, tmp_path, monkeypatch):
    """A synthetic three-chunk phase run (-t 2) over [cpu] * 4 writes the
    one-device run's phased VCF, phaseset.bed and haplotagged BAM. The
    one-device run sees four cards and device='cpu': no mesh."""
    from margin_tpu_torch.phase.driver import run_phase
    args = dict(bam_file=phase_set["bam"],
                reference_fasta=phase_set["fasta"],
                vcf_file=phase_set["vcf"],
                params=Params.load(phase_set["params"]), threads=2,
                use_lut=True, device="cpu", log=lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    one = run_phase(output_base=f"{tmp_path}/one", **args)
    assert executor.context().mesh is None
    executor.enable_mesh(devices=[CPU] * 4)
    ctx = executor.context()
    executor.DEVICE_STATS.reset()
    meshed = run_phase(output_base=f"{tmp_path}/mesh", **args)
    assert executor.context() is ctx
    assert executor.DEVICE_STATS.snapshot()["pairs"] > 0
    with open(f"{tmp_path}/one.chunks.csv") as fh:
        assert len(fh.read().splitlines()) == 3
    assert (one.hap1_count, one.hap2_count) == (meshed.hap1_count,
                                                meshed.hap2_count)
    assert one.hap1_count > 0 and one.hap2_count > 0
    for ext in ("phased.vcf", "phaseset.bed", "haplotagged.bam"):
        assert filecmp.cmp(f"{tmp_path}/one.{ext}", f"{tmp_path}/mesh.{ext}",
                           shallow=False), ext


def test_diploid_on_mesh_byte_identical(diploid_set, tmp_path):
    from margin_tpu_torch.polish.driver import run_polish
    args = dict(bam_file=diploid_set["bam"],
                reference_fasta=diploid_set["fasta"],
                params=Params.load(diploid_set["params"]), diploid=True,
                use_lut=True, device="cpu", log=lambda *a: None)
    one = run_polish(output_base=f"{tmp_path}/one", **args)
    assert executor.context().mesh is None
    executor.enable_mesh(devices=[CPU] * 4)
    executor.DEVICE_STATS.reset()
    meshed = run_polish(output_base=f"{tmp_path}/mesh", **args)
    assert executor.DEVICE_STATS.snapshot()["pairs"] > 0
    assert min(meshed.hap1_count, meshed.hap2_count) > 0
    assert (one.hap1_count, one.hap2_count) == (meshed.hap1_count,
                                                meshed.hap2_count)
    for ext in ("hap1.fa", "hap2.fa", "haplotagged.bam"):
        assert filecmp.cmp(f"{tmp_path}/one.{ext}", f"{tmp_path}/mesh.{ext}",
                           shallow=False), ext


def test_driver_switch_needs_several_cuda_devices(monkeypatch):
    """auto_mesh installs nothing for device='cpu' or with one card, and
    leaves an explicitly enabled mesh in place."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert not executor.auto_mesh("cpu")
    assert executor.context().mesh is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert not executor.auto_mesh("cuda")
    assert executor.context().mesh is None
    executor.enable_mesh(devices=[CPU] * 2)
    ctx = executor.context()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert not executor.auto_mesh("cuda")
    assert executor.context() is ctx


def test_entry_runs():
    fn, (tables, batch) = entry.entry(device="cpu")
    out = fn(tables, batch)
    assert out.shape == (256,) and bool(torch.isfinite(out).all())
    jfn, jargs = graft.entry()
    np.testing.assert_allclose(out.numpy(), np.asarray(jfn(*jargs))[:256],
                               atol=2e-3, rtol=0)


def test_dryrun_multichip_2_on_cpu(monkeypatch):
    """Levels 1 and 2 on [cpu] * 2 (2b runs in
    test_diploid_on_mesh_byte_identical's way; the --hosts level is held
    to margin_tpu by test_torch_diploid_hosts.py)."""
    monkeypatch.setenv("MARGIN_TPU_DRYRUN_NO_DIPLOID", "1")
    monkeypatch.setenv("MARGIN_TPU_DRYRUN_NO_MULTIHOST", "1")
    report = entry.dryrun_multichip(2, devices=[CPU] * 2)
    assert report["mesh"] == {"dp": 2, "sp": 1}
    assert report["level1"] == {"pairs": 16, "shards": 2}
    assert min(report["level2"]["hap_counts"]) > 0
    assert "level2b" not in report and "level3" not in report
    assert executor.context().mesh is None


def test_dryrun_kernel_only(monkeypatch):
    monkeypatch.setenv("MARGIN_TPU_DRYRUN_KERNEL_ONLY", "1")
    report = entry.dryrun_multichip(8, devices=[CPU] * 8)
    assert report["mesh"] == {"dp": 4, "sp": 2}
    assert set(report) == {"mesh", "devices", "level1"}
