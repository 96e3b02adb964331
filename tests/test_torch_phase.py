"""The port's `margin phase` slice end to end against the JAX package.

One seeded synthetic dataset (margin_tpu_torch.testing.synth): a 20 kb
contig at ~12x of 2-6 kb ONT-like reads, ~15 het SNVs and 2 het SVs of
100-300 bp, SV handling on, referenceExpansionForStructuralVariants = 200
so the SV pairs (~500 symbols) take the banded route. margin_tpu's
run_phase (its Pallas kernels in interpret mode, in a subprocess with
XLA's FMA contraction off, see tests/test_torch_pairhmm.py) and
margin_tpu_torch's run_phase(device="cpu") must write byte-identical
phased VCF, phaseset.bed and haplotagged BAM records.
"""

import filecmp
import os
import subprocess
import sys

import pytest
import torch

from margin_tpu_torch.io import bam as bamio
from margin_tpu_torch.ops import banded
from margin_tpu_torch.params import Params
from margin_tpu_torch.phase.driver import run_phase
from margin_tpu_torch.testing.synth import SynthConfig, write_dataset

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = SynthConfig(contig_len=20_000, coverage=12.0, read_len=(2000, 6000),
                     n_snv=15, n_sv=2, sv_len=(100, 300), sv_min_gap=5000,
                     sv_expansion=200, seed=1)


def run_jax_phase(d):
    """Subprocess body: margin_tpu's run_phase on the dataset in `d`."""
    os.environ["MARGIN_TPU_PALLAS"] = "interpret"
    from margin_tpu.params import Params as JaxParams
    from margin_tpu.phase.driver import run_phase as jax_run_phase
    jax_run_phase(f"{d}/reads.bam", f"{d}/ref.fa", f"{d}/calls.vcf",
                  JaxParams.load(f"{d}/params.json"), f"{d}/jax",
                  use_lut=True, seed=0, log=lambda *a: None)


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("phase"))
    ds = write_dataset(d, CONFIG)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2")
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import jax; jax.config.update('jax_platforms', 'cpu')\n"
            "import test_torch_phase as T\n"
            "T.run_jax_phase(%r)\n" % (HERE, os.path.dirname(HERE), d))
    jax_proc = subprocess.Popen([sys.executable, "-c", code], env=env)
    try:
        banded.ROUTES.reset()
        out = run_phase(ds.bam, ds.fasta, ds.vcf, Params.load(ds.params),
                        f"{d}/torch", use_lut=True, seed=0, device="cpu",
                        log=lambda *a: None)
        routes = (banded.ROUTES.pack_items, banded.ROUTES.host_items)
    finally:
        assert jax_proc.wait(timeout=300) == 0
    return d, ds, out, routes


def test_phased_vcf_and_bed_byte_identical(outputs):
    d, _, out, _ = outputs
    assert out.phased_het_count > 0
    for ext in ("phased.vcf", "phaseset.bed"):
        assert filecmp.cmp(f"{d}/torch.{ext}", f"{d}/jax.{ext}",
                           shallow=False), ext


def test_haplotagged_bam_records_identical(outputs):
    d, _, out, _ = outputs
    assert out.hap1_count + out.hap2_count > 0

    def records(path):
        with bamio.BamReader(path) as r:
            return [rec.raw for rec in r]
    assert records(f"{d}/torch.haplotagged.bam") == \
        records(f"{d}/jax.haplotagged.bam")


def test_sv_items_took_the_banded_route(outputs):
    _, ds, _, (pack_items, host_items) = outputs
    assert any(v.kind != "snv" for v in ds.variants)
    assert pack_items >= 1
