"""Haploid `margin polish` across chunk threads, worker processes and
hosts, against the JAX package.

One seeded synthetic set (margin_tpu_torch.testing.synth
.write_polish_dataset): a 2.7 kb draft with substitutions and 1-3 bp
indels, 8x of 0.4-0.9 kb reads with ~8% errors, run-length encoded,
chunks of 1000 bp with 100 bp boundaries: three chunks and two stitch
seams, one POA-consensus iteration and one bubble pass. margin_tpu's
run_polish (threads=2, the LUT logAdd; in a subprocess on its CPU path,
the bands on its exact native engine, XLA's FMA contraction off, as
tests/test_torch_polish.py runs it) is the reference; its chunks draw
from the per-chunk RNG streams random.Random(f"{seed}:{chunk_idx}"),
which -t N, process workers and hosts all use. The port's CLI
(`--device cpu`, each run in a subprocess, torch at one thread) runs:
  * threads: `-t 2`;
  * workers: `--workers process -t 2 --profile` (two CPU worker
    processes scoring through the parent, then the merge; the workers'
    profiles folded into the parent's);
  * hosts: `--hosts 2`, two processes of a gloo group on a free
    localhost port (host 0 writes).
Each must write the polished FASTA and the chunks CSV byte-identical to
margin_tpu's.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

from margin_tpu_torch.testing.synth import (PolishSynthConfig,
                                            write_polish_dataset)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CONFIG = PolishSynthConfig(contig_len=2700, coverage=8.0, read_len=(400, 900),
                           p_sub=0.03, p_ins=0.02, p_del=0.03, chunk_size=1000,
                           chunk_boundary=100, poa_consensus_iterations=1,
                           realign_polish_iterations=1, seed=4)
MODES = ("threads", "workers", "hosts")
FILES = ("chunks.csv", "fa")

_JAX = """
import jax
jax.config.update("jax_platforms", "cpu")
from margin_tpu.params import Params
from margin_tpu.polish.driver import run_polish
d = %r
run_polish(f"{d}/reads.bam", f"{d}/draft.fa", Params.load(f"{d}/params.json"),
           f"{d}/jax/out", threads=2, use_lut=True, log=lambda *a: None)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
                MARGIN_TPU_NATIVE_SCAN_CELLS="1", OMP_NUM_THREADS="1")


def _port(d, mode, *flags):
    """The port's CLI on the dataset, writing d/<mode>/out.*."""
    os.makedirs(f"{d}/{mode}", exist_ok=True)
    return subprocess.Popen(
        [sys.executable, "-m", "margin_tpu_torch", "polish",
         f"{d}/reads.bam", f"{d}/draft.fa", f"{d}/params.json", "-o",
         f"{d}/{mode}/out", "--device", "cpu", "-a", "CRITICAL"]
        + list(flags), env=_env(), cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)


def _done(p, what):
    _, err = p.communicate(timeout=600)
    assert p.returncode == 0, (what, err.decode()[-3000:])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("polish_scale"))
    write_polish_dataset(d, CONFIG)
    os.makedirs(f"{d}/jax")
    procs = {"jax": subprocess.Popen(
        [sys.executable, "-c", _JAX % d], env=_env(), cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE),
        "-t 2": _port(d, "threads", "-t", "2"),
        "--workers process": _port(d, "workers", "-t", "2", "--workers",
                                   "process", "--profile")}
    port = _free_port()
    for h in range(2):
        procs[f"host {h}"] = _port(d, "hosts", "--hosts", "2", "--host-id",
                                   str(h), "--coordinator",
                                   f"127.0.0.1:{port}")
    for what, p in procs.items():
        _done(p, what)
    return d


def test_three_chunks_two_seams(runs):
    with open(f"{runs}/jax/out.chunks.csv") as fh:
        assert len(fh.read().splitlines()) == 3


@pytest.mark.parametrize("mode", MODES)
def test_outputs_identical_to_margin_tpu(runs, mode):
    for f in FILES:
        with open(f"{runs}/{mode}/out.{f}", "rb") as a, \
                open(f"{runs}/jax/out.{f}", "rb") as b:
            assert a.read() == b.read(), (mode, f)


def test_worker_profiles_folded_into_the_parent(runs):
    """The parent's profile holds the workers' three chunks; their own
    files are gone."""
    with open(f"{runs}/workers/out.profile.json") as fh:
        prof = json.load(fh)
    assert len(prof["chunks"]) == 3, prof["chunks"].keys()
    assert prof["chunk_stage_totals_s"]
    assert not [f for f in os.listdir(f"{runs}/workers")
                if ".profile.worker" in f]
