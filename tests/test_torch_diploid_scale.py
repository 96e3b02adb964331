"""Diploid `margin polish` across chunk threads, shards, checkpoints and
worker processes, against the JAX package.

One seeded synthetic set (margin_tpu_torch.testing.synth
.write_diploid_polish_dataset): a 2.3 kb draft with a het site every
150-250 bases, 10x of 0.4-0.8 kb reads, chunks of 800 bp with 150 bp
boundaries: three chunks and two phased seams. margin_tpu's run_polish
(diploid, threads=2, the LUT logAdd; in a subprocess on its CPU path, the
bands on its exact native engine, XLA's FMA contraction off, as
tests/test_torch_diploid.py runs it) is the reference; its chunks draw
from the per-chunk RNG streams random.Random(f"{seed}:{chunk_idx}"),
which -t N, shards, checkpoints and process workers all use. The port's
CLI (`--device cpu`, each run in a subprocess, torch at one thread) runs:
  * threads: `-t 2`;
  * shards: `--shard 0/2` and `--shard 1/2` at once, then `--shard merge`;
  * checkpoint: the shards' checkpoint directory copied, one chunk file
    deleted, then `--checkpoint -t 2`, which resumes two chunks and
    polishes the third;
  * workers: `--workers process -t 2` (two CPU worker processes scoring
    through the parent, then the merge).
Each must write hap1.fa, hap2.fa, the chunks CSV and the haplotagged BAM
byte-identical to margin_tpu's.
"""

import os
import shutil
import subprocess
import sys

import pytest

from margin_tpu_torch.testing.synth import (DiploidPolishSynthConfig,
                                            write_diploid_polish_dataset)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CONFIG = DiploidPolishSynthConfig(
    contig_len=2300, coverage=10.0, read_len=(400, 800),
    het_every=(150, 250), chunk_size=800, chunk_boundary=150, seed=1)
MODES = ("threads", "shards", "checkpoint", "workers")
FILES = ("chunks.csv", "hap1.fa", "hap2.fa", "haplotagged.bam")

_JAX = """
import jax
jax.config.update("jax_platforms", "cpu")
from margin_tpu.params import Params
from margin_tpu.polish.driver import run_polish
d = %r
run_polish(f"{d}/reads.bam", f"{d}/draft.fa", Params.load(f"{d}/params.json"),
           f"{d}/jax/out", diploid=True, threads=2, use_lut=True,
           log=lambda *a: None)
"""


def _port(d, mode, *flags, log="CRITICAL"):
    """The port's CLI on the dataset, writing d/<mode>/out.*."""
    os.makedirs(f"{d}/{mode}", exist_ok=True)
    return subprocess.Popen(
        [sys.executable, "-m", "margin_tpu_torch", "polish",
         f"{d}/reads.bam", f"{d}/draft.fa", f"{d}/params.json", "-o",
         f"{d}/{mode}/out", "--diploid", "--device", "cpu", "-a", log]
        + list(flags), env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
                MARGIN_TPU_NATIVE_SCAN_CELLS="1", OMP_NUM_THREADS="1")


def _done(p, what):
    out, err = p.communicate(timeout=600)
    assert p.returncode == 0, (what, err.decode()[-3000:])
    return out.decode()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("diploid_scale"))
    write_diploid_polish_dataset(d, CONFIG)
    os.makedirs(f"{d}/jax")
    jax = subprocess.Popen([sys.executable, "-c", _JAX % d], env=_env(),
                           cwd=ROOT, stdout=subprocess.DEVNULL,
                           stderr=subprocess.PIPE)
    threads = _port(d, "threads", "-t", "2")
    workers = _port(d, "workers", "-t", "2", "--workers", "process")
    shards = [_port(d, "shards", "--shard", f"{i}/2") for i in range(2)]
    for i, p in enumerate(shards):
        _done(p, f"shard {i}/2")
    # a checkpoint directory with one chunk's file gone, as a run killed
    # before that chunk would leave it
    shutil.copytree(f"{d}/shards/out.checkpoint",
                    f"{d}/checkpoint/out.checkpoint")
    os.remove(f"{d}/checkpoint/out.checkpoint/chunk_00001.pkl")
    merge = _port(d, "shards", "--shard", "merge")
    resume = _port(d, "checkpoint", "--checkpoint", "-t", "2", log="INFO")
    logs = {"merge": _done(merge, "merge"), "resume": _done(resume, "resume"),
            "threads": _done(threads, "-t 2"),
            "workers": _done(workers, "--workers process")}
    _, err = jax.communicate(timeout=600)
    assert jax.returncode == 0, err.decode()[-3000:]
    return d, logs


def test_three_chunks_two_seams(runs):
    d, _ = runs
    with open(f"{d}/jax/out.chunks.csv") as fh:
        assert len(fh.read().splitlines()) == 3


@pytest.mark.parametrize("mode", MODES)
def test_outputs_identical_to_margin_tpu(runs, mode):
    d, _ = runs
    for f in FILES:
        with open(f"{d}/{mode}/out.{f}", "rb") as a, \
                open(f"{d}/jax/out.{f}", "rb") as b:
            assert a.read() == b.read(), (mode, f)


def test_checkpoint_resumed_two_chunks(runs):
    d, logs = runs
    assert "Resumed 2 of 3 chunks from checkpoint" in logs["resume"]
    # a finished run removes its checkpoint directory
    assert not os.path.exists(f"{d}/checkpoint/out.checkpoint")
    assert not os.path.exists(f"{d}/shards/out.checkpoint")
