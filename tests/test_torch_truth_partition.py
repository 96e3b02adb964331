"""The port's truth-haplotype partition of diploid `margin polish -u`
against the JAX package's.

The seeded diploid set of tests/test_torch_diploid.py (2.4 kb draft, a het
site every 150-250 bases, 14x of 0.5-1 kb reads, two chunks) with its
truth.bam: both truth haplotypes aligned to the draft by their edits.
margin_tpu's run_polish(diploid=True, use_lut=True) (in a subprocess, its
CPU path with the banded problems on its exact native engine,
MARGIN_TPU_NATIVE_SCAN_CELLS=1, XLA's FMA contraction off) and
`margin_tpu_torch.cli.main --diploid -u truth.bam --device cpu` (in a
subprocess) run at once. The truth contigs ride along as filtered reads:
the partition TSV, the haplotype FASTAs and the haplotagged BAM must be
byte-identical.
"""

import os
import subprocess
import sys

import pytest

from margin_tpu_torch.testing.synth import write_diploid_polish_dataset

from test_torch_diploid import CONFIG

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run_side(side, d):
    """Subprocess body: one package's diploid polish with -u into
    d/<side>/out.*."""
    out = f"{d}/{side}/out"
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if side == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from margin_tpu.params import Params
        from margin_tpu.polish.driver import run_polish
        run_polish(f"{d}/reads.bam", f"{d}/draft.fa",
                   Params.load(f"{d}/params.json"), out, diploid=True,
                   true_reference_bam=f"{d}/truth.bam", use_lut=True,
                   log=lambda *a: None)
    else:
        import torch
        torch.set_num_threads(1)
        from margin_tpu_torch import cli
        assert cli.main(["polish", f"{d}/reads.bam", f"{d}/draft.fa",
                         f"{d}/params.json", "-o", out, "--diploid", "-u",
                         f"{d}/truth.bam", "-a", "CRITICAL", "--device",
                         "cpu"]) == 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("truth"))
    write_diploid_polish_dataset(d, CONFIG)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               MARGIN_TPU_NATIVE_SCAN_CELLS="1", OMP_NUM_THREADS="1")
    procs = []
    for side in ("jax", "torch"):
        code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
                "import test_torch_truth_partition as T\n"
                "T.run_side(%r, %r)\n" % (HERE, ROOT, side, d))
        procs.append((side, subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)))
    for side, p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, (side, err.decode()[-3000:])
    return d


@pytest.mark.parametrize("name", ["truthHaplotypesPartition.tsv", "hap1.fa",
                                  "hap2.fa", "haplotagged.bam"])
def test_outputs_identical(runs, name):
    with open(f"{runs}/torch/out.{name}", "rb") as a, \
            open(f"{runs}/jax/out.{name}", "rb") as b:
        assert a.read() == b.read()


def test_truth_haplotypes_split_between_the_haplotypes(runs):
    """Each chunk puts truth1 and truth2 on different haplotypes."""
    with open(f"{runs}/torch/out.truthHaplotypesPartition.tsv") as fh:
        rows = [line.rstrip("\n").split("\t") for line in fh
                if not line.startswith("#")]
    by_chunk = {}
    for r in rows:
        by_chunk.setdefault(r[1], {})[r[6]] = r[5]
    assert len(by_chunk) == 2
    for haps in by_chunk.values():
        assert sorted(haps) == ["truth1", "truth2"]
        assert haps["truth1"] != haps["truth2"]
