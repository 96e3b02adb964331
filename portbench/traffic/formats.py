"""The benchmark's own writers of the files `margin phase` and `margin
polish` read: FASTA, VCF, BGZF-compressed BAM with its BAI index. NumPy,
zlib and the standard library only; nothing of the program under test.

The BAI is built while the BAM is written, from each record's virtual
offsets and reference span, by the SAM specification's binning and 16 kb
linear index (a frozen copy of the scheme of the port's `io/bam.py`).
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_MAX_BLOCK = 0xFF00
_NT16 = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _NT16[_c] = _i
CIGAR_M, CIGAR_I, CIGAR_D, CIGAR_S = 0, 1, 2, 4
_REF_CONSUMING = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=bool)


def write_fasta(path: str, name: str, seq: bytes, width: int = 60) -> str:
    with open(path, "wb") as fh:
        fh.write(b">" + name.encode() + b"\n")
        for i in range(0, len(seq), width):
            fh.write(seq[i:i + width] + b"\n")
    return path


def write_vcf(path: str, contig: str, length: int, rows) -> str:
    """rows: (0-based pos, ref, alt, info) het calls, written unphased 0/1
    and PASS."""
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write(f"##contig=<ID={contig},length={length}>\n")
        fh.write('##FORMAT=<ID=GT,Number=1,Type=String,'
                 'Description="Genotype">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                 "\tSAMPLE\n")
        for pos, ref, alt, info in rows:
            fh.write(f"{contig}\t{pos + 1}\t.\t{ref}\t{alt}\t50\tPASS\t{info}"
                     f"\tGT\t0/1\n")
    return path


def bam_record(name: str, flag: int, pos: int, ops: np.ndarray,
               lens: np.ndarray, seq: np.ndarray, quals: np.ndarray,
               mapq: int = 60) -> bytes:
    """A BAM record's payload on reference 0 (the 4-byte length prefix is
    the writer's). ops / lens: the CIGAR as arrays; seq: ASCII bases;
    quals: Phred values."""
    name_b = name.encode() + b"\x00"
    cigar_b = ((lens.astype(np.uint32) << 4)
               | ops.astype(np.uint32)).astype("<u4").tobytes()
    codes = _NT16[seq]
    if len(codes) % 2:
        codes = np.append(codes, 0)
    seq_b = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
    span = int(lens[_REF_CONSUMING[ops]].sum()) or 1
    end = pos + span
    return struct.pack("<iiBBHHHiiii", 0, pos, len(name_b), mapq,
                       _reg2bin(pos, end), len(ops), flag, len(seq), -1, -1,
                       0) + name_b + cigar_b + seq_b + quals.astype(
                           np.uint8).tobytes()


def _reg2bin(beg: int, end: int) -> int:
    """SAM specification reg2bin: the smallest bin holding [beg, end)."""
    end -= 1
    for shift, first in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return first + (beg >> shift)
    return 0


def _block(data: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    head = struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                       0x42, 0x43, 2, len(comp) + 25)
    return head + comp + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                                     len(data))


def write_bam(path: str, contig: str, length: int,
              records: List[Tuple[int, int, bytes]], level: int = 1,
              threads: int = 8) -> str:
    """Write records [(pos, end, payload)], sorted by position, as a
    coordinate-sorted BAM on one reference, and its index at path.bai.
    The BGZF blocks are compressed on `threads` threads."""
    from concurrent.futures import ThreadPoolExecutor
    text = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\t"
            f"LN:{length}\n").encode()
    nb = contig.encode() + b"\x00"
    raw = bytearray(b"BAM\x01" + struct.pack("<i", len(text)) + text
                    + struct.pack("<ii", 1, len(nb)) + nb
                    + struct.pack("<i", length))
    spans = []
    for _, _, rec in records:
        u0 = len(raw)
        raw += struct.pack("<i", len(rec))
        raw += rec
        spans.append((u0, len(raw)))
    blocks = [bytes(raw[i:i + _MAX_BLOCK])
              for i in range(0, len(raw), _MAX_BLOCK)]
    del raw
    with ThreadPoolExecutor(max_workers=threads) as pool:
        comp = list(pool.map(lambda b: _block(b, level), blocks))
    coff = np.concatenate([[0], np.cumsum([len(c) for c in comp])])

    def voff(u: int) -> int:
        return (int(coff[u // _MAX_BLOCK]) << 16) | (u % _MAX_BLOCK)
    with open(path, "wb") as fh:
        for c in comp:
            fh.write(c)
        fh.write(BGZF_EOF)
    bins: dict = {}
    linear: dict = {}
    for (pos, end, _), (u0, u1) in zip(records, spans):
        v0, v1 = voff(u0), voff(u1)
        chunks = bins.setdefault(_reg2bin(pos, end), [])
        if chunks and chunks[-1][1] == v0:
            chunks[-1] = (chunks[-1][0], v1)
        else:
            chunks.append((v0, v1))
        for win in range(pos >> 14, ((end - 1) >> 14) + 1):
            if win not in linear:
                linear[win] = v0
    out = bytearray(b"BAI\x01") + struct.pack("<ii", 1, len(bins))
    for b, chunks in sorted(bins.items()):
        out += struct.pack("<Ii", b, len(chunks))
        for v0, v1 in chunks:
            out += struct.pack("<QQ", v0, v1)
    n_win = max(linear) + 1 if linear else 0
    out += struct.pack("<i", n_win)
    prev = 0
    for win in range(n_win):
        prev = linear.get(win, prev)
        out += struct.pack("<Q", prev)
    with open(path + ".bai", "wb") as fh:
        fh.write(bytes(out))
    return path
