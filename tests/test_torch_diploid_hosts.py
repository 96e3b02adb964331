"""Diploid `margin polish` across two hosts of a gloo group, against the
JAX package.

One seeded synthetic set (margin_tpu_torch.testing.synth
.write_diploid_polish_dataset): a 2.3 kb draft with a het site every
150-250 bases, 10x of 0.3-0.6 kb reads, chunks of 800 bp with 100 bp
boundaries: three chunks and two phased seams. margin_tpu's run_polish
(diploid, threads=2, the LUT logAdd; in a subprocess on its CPU path,
the bands on its exact native engine, XLA's FMA contraction off, as
tests/test_torch_diploid.py runs it) is the reference; its chunks draw
from the per-chunk RNG streams random.Random(f"{seed}:{chunk_idx}"),
which --hosts uses too. The port runs as two CLI processes (`--device
cpu`, torch at one thread) with `--hosts 2` on a free localhost port:
each host polishes the chunks with chunk_idx % 2 == its id, one
all-gather brings every chunk's haplotypes to host 0, which stitches and
writes. hap1.fa, hap2.fa, the chunks CSV and the haplotagged BAM must be
byte-identical to margin_tpu's.
"""

import os
import socket
import subprocess
import sys

import pytest

from margin_tpu_torch.testing.synth import (DiploidPolishSynthConfig,
                                            write_diploid_polish_dataset)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CONFIG = DiploidPolishSynthConfig(
    contig_len=2300, coverage=10.0, read_len=(300, 600),
    het_every=(150, 250), chunk_size=800, chunk_boundary=100, seed=2)
FILES = ("chunks.csv", "hap1.fa", "hap2.fa", "haplotagged.bam")

_JAX = """
import jax
jax.config.update("jax_platforms", "cpu")
from margin_tpu.params import Params
from margin_tpu.polish.driver import run_polish
d = %r
run_polish(f"{d}/reads.bam", f"{d}/draft.fa", Params.load(f"{d}/params.json"),
           f"{d}/jax", diploid=True, threads=2, use_lut=True,
           log=lambda *a: None)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
                MARGIN_TPU_NATIVE_SCAN_CELLS="1", OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("diploid_hosts"))
    write_diploid_polish_dataset(d, CONFIG)
    procs = {"jax": subprocess.Popen(
        [sys.executable, "-c", _JAX % d], env=_env(), cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)}
    port = _free_port()
    for h in range(2):
        procs[f"host {h}"] = subprocess.Popen(
            [sys.executable, "-m", "margin_tpu_torch", "polish",
             f"{d}/reads.bam", f"{d}/draft.fa", f"{d}/params.json", "-o",
             f"{d}/hosts", "--diploid", "--device", "cpu", "-a", "CRITICAL",
             "--hosts", "2", "--host-id", str(h), "--coordinator",
             f"127.0.0.1:{port}"], env=_env(), cwd=ROOT,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    for what, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, (what, err.decode()[-3000:])
    return d


def test_three_chunks_two_seams(runs):
    with open(f"{runs}/jax.chunks.csv") as fh:
        assert len(fh.read().splitlines()) == 3


@pytest.mark.parametrize("name", FILES)
def test_two_hosts_identical_to_margin_tpu(runs, name):
    with open(f"{runs}/hosts.{name}", "rb") as a, \
            open(f"{runs}/jax.{name}", "rb") as b:
        assert a.read() == b.read(), name
