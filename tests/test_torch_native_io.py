"""The native IO engine (native/marginio.cc) built against the port's zlib
stand-in for <libdeflate.h> (margin_tpu_torch/csrc/compat/libdeflate.h)
against the same engine built with the system's libdeflate.

Both are built here into separate shared libraries (`_ext.marginio_command`
with each variant) and bound with `io/native.bind`. The seeded synthetic
BAMs of the phase, haploid polish and diploid polish sets must decode to
the same records through both, whole and by region, and the same as the
pure-Python reader; copies of one with a bad CRC, a damaged deflate
stream or a cut-off last block must fail (or not) the same way. The
engine does not check a block's CRC, so a bad CRC decodes in both.

A haplotagged BAM written through the stand-in decodes to the same
records as one written through libdeflate. The compressed bytes differ:
zlib's deflate and libdeflate's at level 1 choose other matches, so the
two files have different sizes and blocks of the same data.
"""

import ctypes
import shutil
import struct
import subprocess

import numpy as np
import pytest

from margin_tpu_torch import _ext
from margin_tpu_torch.io import bam as bamio
from margin_tpu_torch.io import native
from margin_tpu_torch.testing import synth

VARIANTS = (_ext.DEFLATE_SYSTEM, _ext.DEFLATE_STAND_IN)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """variant -> the bound marginio library, both built side by side."""
    if _ext.deflate_variant() != _ext.DEFLATE_SYSTEM:
        pytest.skip("the system's libdeflate is needed to compare against")
    d = tmp_path_factory.mktemp("marginio")
    procs = {}
    for v in VARIANTS:
        out = str(d / f"libmarginio_{v.replace(' ', '_')}.so")
        procs[v] = (out, subprocess.Popen(_ext.marginio_command(out, v),
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
    libs = {}
    for v, (out, p) in procs.items():
        log, _ = p.communicate()
        assert p.returncode == 0, log.decode(errors="replace")
        libs[v] = native.bind(ctypes.CDLL(out))
    return libs


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("bams")
    ph = synth.write_dataset(str(d / "phase"), synth.SynthConfig(seed=2))
    po = synth.write_polish_dataset(str(d / "polish"), synth.PolishSynthConfig(
        contig_len=6000, coverage=10.0, seed=4))
    di = synth.write_diploid_polish_dataset(
        str(d / "diploid"), synth.DiploidPolishSynthConfig(
            contig_len=6000, coverage=12.0, read_len=(1500, 3000), seed=5))
    return {"phase": (ph.bam, ph.contig), "polish": (po.bam, po.contig),
            "diploid": (di.bam, di.contig)}


def _decode(engine, path, contig):
    """(scan arrays, every record by region fetch, a window's records) or
    the exception the engine raised."""
    try:
        with native.NativeBam(path, engine=engine) as nb:
            scan = nb.scan()
            tid = nb.ref_names.index(contig)
            n = nb.ref_lengths[tid]
            whole = list(nb.fetch_raw(tid, 0, n))
            window = list(nb.fetch_raw(tid, n // 3, n // 3 + 1500))
    except (IOError, OSError, ValueError) as e:
        return type(e).__name__
    return ({k: (v if k == "names" else v.tolist())
             for k, v in scan.items()}, whole, window)


@pytest.mark.parametrize("which", ["phase", "polish", "diploid"])
def test_test_bams_decode_to_the_same_records(engines, bams, which):
    path, contig = bams[which]
    got = {v: _decode(engines[v], path, contig) for v in VARIANTS}
    assert not isinstance(got[_ext.DEFLATE_SYSTEM], str)
    assert got[_ext.DEFLATE_STAND_IN] == got[_ext.DEFLATE_SYSTEM]
    with bamio.BamReader(path) as r:
        py = [rec for rec in r if not rec.is_unmapped]
    scan, whole, _ = got[_ext.DEFLATE_STAND_IN]
    assert scan["names"] == [rec.name for rec in py]
    assert [bamio.parse_record(raw).name for raw in whole] == \
        [rec.name for rec in py]


def _blocks(path):
    """(offset, size) of each BGZF block of the file."""
    data = open(path, "rb").read()
    out, off = [], 0
    while off < len(data):
        bsize = struct.unpack_from("<H", data, off + 16)[0] + 1
        out.append((off, bsize))
        off += bsize
    return data, out


def _damaged(src, dst, how):
    data, blocks = _blocks(src)
    off, size = blocks[len(blocks) // 2]
    buf = bytearray(data)
    if how == "bad_crc":
        crc = off + size - 8
        buf[crc:crc + 4] = bytes(b ^ 0xFF for b in buf[crc:crc + 4])
    elif how == "bad_stream":
        # a reserved block type (BTYPE 3) at the first deflate block header
        buf[off + 18] |= 0x06
    else:  # the last data block cut in half, the EOF block gone
        last_off, last_size = blocks[-2]
        buf = buf[:last_off + last_size // 2]
    with open(dst, "wb") as fh:
        fh.write(bytes(buf))
    shutil.copy(src + ".bai", dst + ".bai")


@pytest.mark.parametrize("how", ["bad_crc", "bad_stream", "truncated"])
def test_damaged_blocks_fail_the_same_way(engines, bams, tmp_path, how):
    src, contig = bams["phase"]
    path = str(tmp_path / f"{how}.bam")
    _damaged(src, path, how)
    got = {v: _decode(engines[v], path, contig) for v in VARIANTS}
    assert got[_ext.DEFLATE_STAND_IN] == got[_ext.DEFLATE_SYSTEM]
    whole = _decode(engines[_ext.DEFLATE_SYSTEM], src, contig)
    if how == "bad_crc":     # not checked: the same records as the source
        assert got[_ext.DEFLATE_SYSTEM] == whole
    else:
        assert got[_ext.DEFLATE_SYSTEM] != whole


def _records(path):
    with bamio.BamReader(path) as r:
        return [(rec.name, rec.flag, rec.pos, rec.tags_blob()) for rec in r]


def test_haplotagged_bam_through_the_stand_in(engines, bams, tmp_path):
    src, _ = bams["diploid"]
    with native.NativeBam(src, engine=engines[_ext.DEFLATE_SYSTEM]) as nb:
        names = list(dict.fromkeys(nb.scan()["names"]))
    rng = np.random.default_rng(0)
    tags = {n: int(rng.integers(1, 3)) for n in names[: 2 * len(names) // 3]}
    outs, counts = {}, {}
    for v in VARIANTS:
        outs[v] = str(tmp_path / f"{v.replace(' ', '_')}.bam")
        counts[v] = native.write_haplotagged_native(src, outs[v], tags,
                                                    engine=engines[v])
    assert counts[_ext.DEFLATE_STAND_IN] == counts[_ext.DEFLATE_SYSTEM]
    recs = {v: _records(p) for v, p in outs.items()}
    assert recs[_ext.DEFLATE_STAND_IN] == recs[_ext.DEFLATE_SYSTEM]
    assert sum(b"HPi" in t for _, _, _, t in recs[_ext.DEFLATE_SYSTEM]) \
        == len(tags)
    # each engine reads the other's file back to the same records
    with native.NativeBam(outs[_ext.DEFLATE_SYSTEM],
                          engine=engines[_ext.DEFLATE_STAND_IN]) as nb:
        a = nb.scan()["names"]
    with native.NativeBam(outs[_ext.DEFLATE_STAND_IN],
                          engine=engines[_ext.DEFLATE_SYSTEM]) as nb:
        b = nb.scan()["names"]
    assert a == b == [r[0] for r in recs[_ext.DEFLATE_SYSTEM]]
    raw = {v: open(p, "rb").read() for v, p in outs.items()}
    assert raw[_ext.DEFLATE_STAND_IN] != raw[_ext.DEFLATE_SYSTEM]
