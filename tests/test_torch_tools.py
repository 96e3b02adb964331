"""The port's aux tools (margin_tpu_torch.tools, `python -m
margin_tpu_torch <tool>`) against the JAX package's on seeded synthetic
sets.

- calcLocalPhasingCorrectness on a truth phased VCF and a query with two
  phase sets and a few flipped genotypes: identical standard output, and
  the per-variant table (-p) too.
- tagFromIds on the polish set's reads with a TSV of H1 / HP:i:2 / none
  tags: identical haplotagged BAM records (decoded: name, flag, position,
  tags).
- runLengthMatrix on the polish set: identical run-length matrices.
- tagFromPhasedVcf on a phase set with its variants phased by their true
  haplotypes, `--device cpu` (K1's plain twin): identical haplotagged BAM
  records. The JAX side runs in a subprocess with XLA's FMA contraction
  off, as the allele likelihoods (exact logAdd) feed read votes.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from margin_tpu_torch.testing.synth import (PolishSynthConfig, SynthConfig,
                                            write_dataset,
                                            write_polish_dataset)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _phased_vcf(ds, path, flip=(), split_at=None):
    """ds's variants with GT phased by their true haplotype and a PS; flip:
    variant indices whose haplotypes swap; split_at: the index where a
    second phase set starts."""
    with open(ds.vcf) as fh:
        lines = fh.read().splitlines()
    out = []
    i = 0
    for line in lines:
        if line.startswith("##FORMAT"):
            out.append(line)
            out.append('##FORMAT=<ID=PS,Number=1,Type=Integer,'
                       'Description="Phase set">')
            continue
        if line.startswith("#"):
            out.append(line)
            continue
        f = line.split("\t")
        hap = ds.variants[i].hap ^ (3 if i in flip else 0)
        ps = 1 if split_at is None or i < split_at else 2
        f[8] = "GT:PS"
        f[9] = f"{'1|0' if hap == 1 else '0|1'}:{ps}"
        out.append("\t".join(f))
        i += 1
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")
    return path


def _tool_runs(pkg, d, phase, polish, out):
    """The four tools of `pkg` on the sets; their outputs under out."""
    os.makedirs(out, exist_ok=True)
    cli = __import__(f"{pkg}.cli", fromlist=["main"])
    for name, argv in (("lpc", [f"{d}/truth.vcf", f"{d}/query.vcf"]),
                       ("lpc_per_variant", ["-p", f"{d}/truth.vcf",
                                            f"{d}/query.vcf"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["calcLocalPhasingCorrectness", "-q"] + argv) \
                in (0, None)
        with open(f"{out}/{name}.tsv", "w") as fh:
            fh.write(buf.getvalue())
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["tagFromIds", polish["bam"], f"{d}/ids.tsv", "-o",
                  f"{out}/ids"])
        cli.main(["runLengthMatrix", polish["bam"], polish["draft"],
                  polish["params"], "-o", f"{out}/rlm"])
        dev = ["--device", "cpu"] if pkg == "margin_tpu_torch" else []
        cli.main(["tagFromPhasedVcf", phase["bam"], phase["fasta"],
                  f"{d}/truth.vcf", phase["params"], "-o", f"{out}/pvcf"]
                 + dev)


def run_jax_side(d, phase, polish):
    import jax
    jax.config.update("jax_platforms", "cpu")
    _tool_runs("margin_tpu", d, phase, polish, f"{d}/jax")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tools"))
    ph = write_dataset(f"{d}/phase", SynthConfig(
        contig_len=6000, coverage=8.0, read_len=(1000, 3000), n_snv=14,
        n_sv=0, seed=4))
    po = write_polish_dataset(f"{d}/polish", PolishSynthConfig(
        contig_len=3000, coverage=6.0, read_len=(600, 1500), chunk_size=1500,
        chunk_boundary=150, seed=5))
    _phased_vcf(ph, f"{d}/truth.vcf")
    _phased_vcf(ph, f"{d}/query.vcf", flip=(3, 9), split_at=7)
    rng = np.random.default_rng(6)
    from margin_tpu_torch.io import bam as bamio
    with bamio.BamReader(po.bam) as r:
        names = sorted({rec.name for rec in r})
    tags = ["H1", "HP:i:2", "none", "H2", "H0"]
    with open(f"{d}/ids.tsv", "w") as fh:
        for n in names:
            if rng.random() < 0.7:
                fh.write(f"{n}\t{tags[int(rng.integers(0, len(tags)))]}\n")
    phase = {"bam": ph.bam, "fasta": ph.fasta, "params": ph.params}
    polish = {"bam": po.bam, "draft": po.draft, "params": po.params}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", OMP_NUM_THREADS="1")
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import test_torch_tools as T\n"
            "T.run_jax_side(%r, %r, %r)\n" % (HERE, ROOT, d, phase, polish))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        _tool_runs("margin_tpu_torch", d, phase, polish, f"{d}/torch")
    finally:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err.decode()[-3000:]
    return d, ph


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


@pytest.mark.parametrize("name", ["lpc.tsv", "lpc_per_variant.tsv"])
def test_lpc_output_identical(runs, name):
    d, _ = runs
    assert _same_bytes(f"{d}/torch/{name}", f"{d}/jax/{name}")
    with open(f"{d}/torch/{name}") as fh:
        assert len(fh.read().splitlines()) > 2


def test_run_length_matrices_identical(runs):
    d, _ = runs
    files = sorted(f for f in os.listdir(f"{d}/torch")
                   if f.startswith("rlm."))
    assert files == sorted(f for f in os.listdir(f"{d}/jax")
                           if f.startswith("rlm."))
    assert len(files) == 4
    for f in files:
        assert _same_bytes(f"{d}/torch/{f}", f"{d}/jax/{f}"), f


def _records(path):
    from margin_tpu_torch.io import bam as bamio
    with bamio.BamReader(path) as r:
        return [(rec.name, rec.flag, rec.pos, rec.tags_blob()) for rec in r]


@pytest.mark.parametrize("name", ["ids", "pvcf"])
def test_haplotagged_bam_records_identical(runs, name):
    d, _ = runs
    mine = _records(f"{d}/torch/{name}.haplotagged.bam")
    assert mine == _records(f"{d}/jax/{name}.haplotagged.bam")
    assert sum(b"HPi" in tags for *_, tags in mine) > 0


def test_tag_from_phased_vcf_follows_the_true_haplotypes(runs):
    """The VCF is phased by the true haplotypes, so the tags follow the
    reads' origins."""
    import struct
    d, ph = runs
    agree = tagged = 0
    for name, _, _, blob in _records(f"{d}/torch/pvcf.haplotagged.bam"):
        i = blob.find(b"HPi")
        if i < 0:
            continue
        tagged += 1
        agree += struct.unpack_from("<i", blob, i + 3)[0] == \
            ph.read_hap[name]
    assert tagged >= len(ph.read_hap) // 2
    assert agree >= 0.9 * tagged
