"""The port never imports JAX or the JAX package, and never falls back to
the CPU by itself."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "margin_tpu_torch")

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+margin_tpu(\.|\s|$)"
    r"|from\s+margin_tpu(\.|\s+import))", re.M)


def test_static_scan_finds_no_jax_or_margin_tpu_import():
    hits = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    for m in _FORBIDDEN.finditer(fh.read()):
                        hits.append(f"{path}: {m.group(0).strip()}")
    assert not hits, hits


def test_pattern_tells_the_packages_apart():
    assert _FORBIDDEN.search("from margin_tpu.ops import banded")
    assert _FORBIDDEN.search("import margin_tpu")
    assert _FORBIDDEN.search("from margin_tpu import params")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from margin_tpu_torch.ops import banded")
    assert not _FORBIDDEN.search("import margin_tpu_torch")


_RUN = r"""
import sys, tempfile
import torch
torch.set_num_threads(1)
import margin_tpu_torch
from margin_tpu_torch.params import Params
from margin_tpu_torch.phase.driver import run_phase
from margin_tpu_torch.testing.synth import SynthConfig, write_dataset
d = tempfile.mkdtemp()
ds = write_dataset(d, SynthConfig(contig_len=8000, coverage=6.0,
                                  read_len=(1500, 3000), n_snv=6, n_sv=1,
                                  sv_len=(80, 120), sv_min_gap=3000,
                                  sv_expansion=150, seed=2))
out = run_phase(ds.bam, ds.fasta, ds.vcf, Params.load(ds.params),
                d + "/o", use_lut=True, device="cpu", log=lambda *a: None)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "margin_tpu"))
print("BAD", bad)
print("HAPS", out.hap1_count + out.hap2_count)
"""


def test_phase_run_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _RUN], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "BAD []" in res.stdout, res.stdout
    assert int(res.stdout.split("HAPS")[1].split()[0]) > 0


def test_cuda_requested_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from margin_tpu_torch.params import Params
    from margin_tpu_torch.phase.driver import run_phase
    from margin_tpu_torch.testing.synth import SynthConfig, write_dataset
    ds = write_dataset(str(tmp_path), SynthConfig(
        contig_len=6000, coverage=3.0, read_len=(1000, 2000), n_snv=3,
        n_sv=0, seed=3))
    with pytest.raises(RuntimeError, match="cuda"):
        run_phase(ds.bam, ds.fasta, ds.vcf, Params.load(ds.params),
                  str(tmp_path / "o"), device="cuda", log=lambda *a: None)


def test_cli_rejects_unported_parts(capsys):
    """What is not ported stops with its ROADMAP item. Diploid
    --checkpoint, --workers process -t N, --hosts with --host-id, the
    HELEN flags and the aux tools parse (here they stop on the missing
    inputs and arguments); --hosts without --host-id is refused, as in
    margin_tpu."""
    from margin_tpu_torch import cli
    for flags, item in ((["--diploid", "--checkpoint"],
                         "Could not read from input"),
                        (["--workers", "process", "-t", "2"],
                         "Could not read from input"),
                        (["--hosts", "2", "--host-id", "1", "--coordinator",
                          "127.0.0.1:1"], "Could not read from input"),
                        (["--hosts", "2"], "--hosts requires --host-id"),
                        (["-u", "truth.bam"], "Could not read from input"),
                        (["-f"], "Could not read from input")):
        with pytest.raises(SystemExit):
            cli.main(["polish", "a", "b", "c"] + flags)
        assert item in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["tagFromIds"])
    assert "the following arguments are required" in capsys.readouterr().err
