"""CRAM and BCF input in the port (margin_tpu_torch/io/cram.py, io/bcf.py,
`io/bam.py:open_alignment`, `io/vcf.py:_open_text`) against margin_tpu's.

The codecs are held against margin_tpu.io.cram / io.bcf on the same seeded
bytes. Each package writes a seeded synthetic BAM as CRAM, and each
package's reader decodes both files to the BAM's records (records and
decoded blocks are compared, not file bytes: the writer's gzip blocks
carry the time). `margin phase` from CRAM + BCF and haploid `margin
polish` from CRAM, with run_phase / run_polish(device="cpu"), write the
bytes margin_tpu's run_phase / run_polish write on the same CRAM and BCF
(in a subprocess: its Pallas kernels in interpret mode, XLA's FMA
contraction off, polish bands on its exact native engine, as
tests/test_torch_phase.py and tests/test_torch_polish.py run it), and the
bytes of the port's own BAM + VCF run.

vcf_to_bcf (both packages) encodes no INFO field: its profile is CHROM,
POS, ID, alleles, QUAL, FILTER and the FORMAT values. So a BCF it wrote
decodes to the VCF's lines with "." in INFO, and a phased VCF from it
differs from the BAM + VCF run's in that column only; the tests hold
both to exactly that.
"""

import filecmp
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from margin_tpu.io import bcf as jax_bcf
from margin_tpu.io import cram as jax_cram
from margin_tpu_torch.io import bam as bamio
from margin_tpu_torch.io import bcf, cram, vcf
from margin_tpu_torch.params import Params
from margin_tpu_torch.phase.driver import run_phase
from margin_tpu_torch.polish.driver import run_polish
from margin_tpu_torch.testing.synth import (PolishSynthConfig, SynthConfig,
                                            write_dataset,
                                            write_polish_dataset)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
PHASE = SynthConfig(contig_len=12_000, coverage=10.0, read_len=(2000, 5000),
                    n_snv=10, n_sv=1, sv_len=(100, 300), sv_min_gap=4000,
                    sv_expansion=200, seed=1)
POLISH = PolishSynthConfig(contig_len=2000, coverage=6.0, read_len=(500, 1000),
                           p_sub=0.03, p_ins=0.02, p_del=0.03,
                           chunk_size=2500, chunk_boundary=160,
                           poa_consensus_iterations=1, seed=4)


# -- codecs ------------------------------------------------------------------

def test_itf8_ltf8_round_trip_against_margin_tpu():
    rng = np.random.default_rng(0)
    vals = [0, 1, 127, 128, 0x3FFF, 0x4000, 0x1FFFFF, 0xFFFFFFF, 2**31 - 1,
            -1, -2] + [int(v) for v in rng.integers(-2**31, 2**31, 200)]
    for v in vals:
        enc = cram.write_itf8(v)
        assert enc == jax_cram.write_itf8(v)
        assert cram.ByteCursor(enc).itf8() == v
        assert jax_cram.ByteCursor(enc).itf8() == v
    lvals = [0, 127, 128, 2**16, 2**31, 2**40, 2**55, 2**63 - 1] + [
        int(v) for v in rng.integers(0, 2**62, 200)]
    for v in lvals:
        enc = cram.write_ltf8(v)
        assert enc == jax_cram.write_ltf8(v)
        assert cram.ByteCursor(enc).ltf8() == v
        assert jax_cram.ByteCursor(enc).ltf8() == v
    arr = [int(v) for v in rng.integers(0, 2**20, 50)]
    assert cram.write_itf8_array(arr) == jax_cram.write_itf8_array(arr)
    assert cram.ByteCursor(cram.write_itf8_array(arr)).itf8_array() == arr


def _freqs(counts):
    """Counts normalised to 4096 with every used symbol >= 1."""
    used = np.nonzero(counts)[0]
    f = np.zeros(256, dtype=np.int64)
    f[used] = np.maximum(1, (counts[used] * 4096) // max(1, counts.sum()))
    f[used[np.argmax(counts[used])]] += 4096 - f.sum()
    cum = np.zeros(257, dtype=np.int64)
    cum[1:] = np.cumsum(f)
    return f, cum


def _freq_table(f):
    """An order-0 frequency table: symbol, itf8 frequency, ..., 0 (the
    symbols are chosen with no two consecutive, so no run-length byte)."""
    used = np.nonzero(f)[0]
    assert not any(b - a == 1 for a, b in zip(used, used[1:]))
    out = bytearray()
    for s in used:
        out.append(int(s))
        out += cram.write_itf8(int(f[s]))
    out.append(0)
    return bytes(out)


def _rans_put(x, f, c, emitted):
    x_max = ((cram._RANS_LOW >> 12) << 8) * f
    while x >= x_max:
        emitted.append(x & 0xFF)
        x >>= 8
    return ((x // f) << 12) + (x % f) + c


def _rans_encode(data: bytes, order: int) -> bytes:
    """A small rANS 4x8 encoder (the test's oracle for both decoders):
    order 0 interleaves the four states byte by byte; order 1 gives each
    state a quarter of the data (state 3 the tail) with the previous byte
    of its quarter as the context."""
    n = len(data)
    states = [cram._RANS_LOW] * 4
    emitted = []
    if order == 0:
        f, cum = _freqs(np.bincount(np.frombuffer(data, np.uint8),
                                    minlength=256))
        table = _freq_table(f)
        for i in range(n - 1, -1, -1):
            s = data[i]
            states[i & 3] = _rans_put(states[i & 3], int(f[s]), int(cum[s]),
                                      emitted)
    else:
        q = n >> 2
        starts = [0, q, 2 * q, 3 * q]
        events = [(j, starts[j] + i) for i in range(q) for j in range(4)]
        events += [(3, i) for i in range(4 * q, n)]
        ctx_of = {}
        for j, i in events:
            ctx_of[i] = 0 if i == starts[j] else data[i - 1]
        counts = np.zeros((256, 256), dtype=np.int64)
        for i, cx in ctx_of.items():
            counts[cx, data[i]] += 1
        tables = {cx: _freqs(counts[cx]) for cx in range(256)
                  if counts[cx].any()}
        ctxs = sorted(tables)
        assert not any(b - a == 1 for a, b in zip(ctxs, ctxs[1:]))
        table = b"".join(bytes([cx]) + _freq_table(tables[cx][0])
                         for cx in ctxs) + b"\x00"
        for j, i in reversed(events):
            f, cum = tables[ctx_of[i]]
            s = data[i]
            states[j] = _rans_put(states[j], int(f[s]), int(cum[s]), emitted)
    body = table + b"".join(struct.pack("<I", st) for st in states) \
        + bytes(reversed(emitted))
    return bytes([order]) + cram.write_itf8(len(body)) \
        + cram.write_itf8(n) + body


@pytest.mark.parametrize("order", [0, 1])
def test_rans_round_trip_against_margin_tpu(order):
    rng = np.random.default_rng(1 + order)
    for n in (4, 7, 1001, 6000):
        data = bytes(b"ACGT"[i] for i in rng.integers(0, 4, n))
        enc = _rans_encode(data, order)
        assert cram.rans_decode(enc, n) == data
        assert jax_cram.rans_decode(enc, n) == data


# -- CRAM records ------------------------------------------------------------

@pytest.fixture(scope="module")
def phase_set(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cram_phase"))
    ds = write_dataset(d, PHASE)
    cram.bam_to_cram(ds.bam, f"{d}/reads.cram", ds.fasta)
    jax_cram.bam_to_cram(ds.bam, f"{d}/jax_reads.cram", ds.fasta)
    with open(ds.vcf) as fh:
        bcf.vcf_to_bcf(fh.read().splitlines(), f"{d}/calls.bcf")
    return d, ds


def _fields(rec):
    """A record's whole BAM payload (name, flag, position, CIGAR, sequence,
    qualities, tags, mate fields)."""
    return bytes(rec.raw)


def test_each_reader_decodes_each_writer_to_the_bam(phase_set):
    d, ds = phase_set
    with bamio.BamReader(ds.bam) as r:
        want = [_fields(rec) for rec in r]
    assert len(want) > 20
    for path in (f"{d}/reads.cram", f"{d}/jax_reads.cram"):
        for reader in (cram.CramReader, jax_cram.CramReader):
            with reader(path, ds.fasta) as r:
                assert [_fields(rec) for rec in r] == want, (path, reader)
        with bamio.open_alignment(path, ds.fasta) as r:
            assert isinstance(r, cram.CramReader)
            assert r.header.ref_names == [ds.contig]


def _decoded_blocks(mod, path):
    """Every block of every container, decompressed: (content type, id,
    method, data)."""
    with open(path, "rb") as fh:
        data = fh.read()
    rd = mod.CramReader.__new__(mod.CramReader)
    cur = mod.ByteCursor(data, 26)
    out = []
    while cur.pos < len(data):
        hdr = rd._container_header(cur)
        end = cur.pos + hdr[0]
        while cur.pos < end:
            b = mod.read_block(cur)
            out.append((b.content_type, b.content_id, b.method, b.data))
        cur.pos = end
    return out


def test_writers_emit_the_same_decoded_blocks(phase_set):
    d, _ = phase_set
    ours = _decoded_blocks(cram, f"{d}/reads.cram")
    theirs = _decoded_blocks(jax_cram, f"{d}/jax_reads.cram")
    assert len(ours) > 10 and ours == theirs
    assert _decoded_blocks(jax_cram, f"{d}/reads.cram") == ours


def test_fetch_matches_the_bam_region(phase_set):
    d, ds = phase_set
    with bamio.BamReader(ds.bam) as b, \
            cram.CramReader(f"{d}/reads.cram", ds.fasta) as c:
        for start, end in ((0, 3000), (5000, 5001), (9000, 12_000)):
            assert [_fields(r) for r in c.fetch(ds.contig, start, end)] == \
                [_fields(r) for r in b.fetch(ds.contig, start, end)]


# -- BCF ---------------------------------------------------------------------

def test_vcf_to_bcf_equal_between_packages(phase_set, tmp_path):
    d, ds = phase_set
    with open(ds.vcf) as fh:
        lines = fh.read().splitlines()
    jax_bcf.vcf_to_bcf(lines, str(tmp_path / "jax.bcf"))
    assert filecmp.cmp(f"{d}/calls.bcf", str(tmp_path / "jax.bcf"),
                       shallow=False)
    assert bcf.is_bcf(f"{d}/calls.bcf") and not bcf.is_bcf(ds.vcf)
    assert list(bcf.BcfReader(f"{d}/calls.bcf").lines()) == \
        list(jax_bcf.BcfReader(f"{d}/calls.bcf").lines())


def _same_but_info(vcf_lines, bcf_lines):
    """bcf_lines equal vcf_lines except the INFO column of data lines,
    which is "." in bcf_lines (vcf_to_bcf encodes no INFO). Returns the
    data lines whose INFO was dropped."""
    assert len(vcf_lines) == len(bcf_lines)
    dropped = 0
    for a, b in zip(vcf_lines, bcf_lines):
        if a.startswith("#"):
            assert a == b
            continue
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[:7] + fa[8:] == fb[:7] + fb[8:]
        assert fb[7] == "."
        dropped += fa[7] != "."
    return dropped


def test_open_text_reads_the_bcf(phase_set):
    d, ds = phase_set
    got = list(vcf._open_text(f"{d}/calls.bcf"))
    want = list(vcf._open_text(ds.vcf))
    assert len(want) > PHASE.n_snv
    assert _same_but_info(want, got) == PHASE.n_sv


# -- phase and polish from CRAM / BCF ------------------------------------------

def run_jax_side(phase_dir, polish_dir):
    """Subprocess body: margin_tpu's run_phase on the CRAM + BCF and its
    run_polish on the CRAM."""
    os.environ["MARGIN_TPU_PALLAS"] = "interpret"
    from margin_tpu.params import Params as JaxParams
    from margin_tpu.phase.driver import run_phase as jax_run_phase
    from margin_tpu.polish.driver import run_polish as jax_run_polish
    jax_run_phase(f"{phase_dir}/reads.cram", f"{phase_dir}/ref.fa",
                  f"{phase_dir}/calls.bcf",
                  JaxParams.load(f"{phase_dir}/params.json"),
                  f"{phase_dir}/jax", use_lut=True, seed=0,
                  log=lambda *a: None)
    jax_run_polish(f"{polish_dir}/reads.cram", f"{polish_dir}/draft.fa",
                   JaxParams.load(f"{polish_dir}/params.json"),
                   f"{polish_dir}/jax", use_lut=True, log=lambda *a: None)


@pytest.fixture(scope="module")
def runs(phase_set, tmp_path_factory):
    d, ds = phase_set
    p = str(tmp_path_factory.mktemp("cram_polish"))
    pds = write_polish_dataset(p, POLISH)
    cram.bam_to_cram(pds.bam, f"{p}/reads.cram", pds.draft)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               MARGIN_TPU_NATIVE_SCAN_CELLS="1")
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import jax; jax.config.update('jax_platforms', 'cpu')\n"
            "import test_torch_cram_bcf as T\n"
            "T.run_jax_side(%r, %r)\n" % (HERE, os.path.dirname(HERE), d, p))
    jax_proc = subprocess.Popen([sys.executable, "-c", code], env=env)
    try:
        for reads, calls, out in ((f"{d}/reads.cram", f"{d}/calls.bcf",
                                   "cram"), (ds.bam, ds.vcf, "bam")):
            run_phase(reads, ds.fasta, calls, Params.load(ds.params),
                      f"{d}/{out}", use_lut=True, seed=0, device="cpu",
                      log=lambda *a: None)
        for reads, out in ((f"{p}/reads.cram", "cram"), (pds.bam, "bam")):
            run_polish(reads, pds.draft, Params.load(pds.params),
                       f"{p}/{out}", use_lut=True, device="cpu",
                       log=lambda *a: None)
    finally:
        assert jax_proc.wait(timeout=600) == 0
    return d, p


def test_phase_from_cram_and_bcf_equals_margin_tpu(runs):
    d, _ = runs
    for ext in ("phased.vcf", "phaseset.bed"):
        assert filecmp.cmp(f"{d}/cram.{ext}", f"{d}/jax.{ext}",
                           shallow=False), ext


def test_phase_from_cram_and_bcf_equals_bam_and_vcf(runs):
    d, _ = runs
    assert filecmp.cmp(f"{d}/cram.phaseset.bed", f"{d}/bam.phaseset.bed",
                       shallow=False)
    with open(f"{d}/bam.phased.vcf") as a, open(f"{d}/cram.phased.vcf") as b:
        bam_lines, cram_lines = a.read().splitlines(), b.read().splitlines()
    assert _same_but_info(bam_lines, cram_lines) == PHASE.n_sv

    def records(path):
        with bamio.BamReader(path) as r:
            return [_fields(rec) for rec in r]
    got = records(f"{d}/cram.haplotagged.bam")
    assert got == records(f"{d}/bam.haplotagged.bam")
    assert sum(b"HPi" in raw for raw in got) > 0


def test_tools_read_cram(runs, phase_set):
    """runLengthMatrix and tagFromPhasedVcf (the tools that take a
    reference FASTA, which the CRAM decodes against) give the same outputs
    from a CRAM as from its BAM."""
    import contextlib
    import io
    from margin_tpu_torch import cli
    d, p = runs
    _, ds = phase_set
    for reads, out in ((f"{p}/reads.cram", "cram"), (f"{p}/reads.bam", "bam")):
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["runLengthMatrix", reads, f"{p}/draft.fa",
                      f"{p}/params.json", "-o", f"{p}/rlm_{out}"])
    for base in "ACGT":
        assert filecmp.cmp(f"{p}/rlm_cram.run_lengths.{base}.tsv",
                           f"{p}/rlm_bam.run_lengths.{base}.tsv",
                           shallow=False), base
    for reads, out in ((f"{d}/reads.cram", "cram"), (ds.bam, "bam")):
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["tagFromPhasedVcf", reads, ds.fasta,
                      f"{d}/bam.phased.vcf", ds.params, "-o",
                      f"{d}/tag_{out}", "--device", "cpu"])

    def records(path):
        with bamio.BamReader(path) as r:
            return [_fields(rec) for rec in r]
    got = records(f"{d}/tag_cram.haplotagged.bam")
    assert got == records(f"{d}/tag_bam.haplotagged.bam")
    assert sum(b"HPi" in raw for raw in got) > 0


def test_polish_from_cram_equals_margin_tpu_and_bam(runs):
    _, p = runs
    with open(f"{p}/cram.fa", "rb") as fh:
        got = fh.read()
    for other in ("jax", "bam"):
        with open(f"{p}/{other}.fa", "rb") as fh:
            assert fh.read() == got, other
    assert len(got) > 1000
