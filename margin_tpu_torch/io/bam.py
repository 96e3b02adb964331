"""BAM reader/writer with BAI region queries.

Host-side replacement for the htslib usage in the reference
(impl/htsIntegration.c): sequential scan (bamChunker_construct2), region
iteration (sam_itr_regions), and the haplotagged-BAM rewrite
(writeHaplotaggedBam, htsIntegration.c:1310-1503).

Records parse lazily into numpy-backed fields; cigar ops stay as the raw
uint32 array (op = v & 0xF, len = v >> 4) so downstream walks are
vectorizable.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from margin_tpu_torch.io.bgzf import BgzfReader, BgzfWriter

# cigar op codes (BAM spec)
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF = range(9)

# 4-bit encoded seq -> ascii ("=ACMGRSVTWYHKDBN")
_SEQ_NT16 = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
_NT16_TABLE = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _NT16_TABLE[_c] = _i
    _NT16_TABLE[ord(chr(_c).lower())] = _i

FUNMAP = 0x4
FREVERSE = 0x10
FSECONDARY = 0x100
FSUPPLEMENTARY = 0x800

# ops that consume reference / query
_CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=bool)
_CONSUMES_QUERY = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=bool)


@dataclass
class BamRecord:
    name: str
    flag: int
    ref_id: int
    pos: int  # 0-based leftmost
    mapq: int
    cigar: np.ndarray  # uint32 raw ops
    raw: bytes  # the full record payload (after block_size), for rewrite

    _l_seq: int = 0
    _seq_off: int = 0
    _qual_off: int = 0
    _tag_off: int = 0

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FSECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FSUPPLEMENTARY)

    @property
    def l_seq(self) -> int:
        return self._l_seq

    def cigar_ops(self) -> np.ndarray:
        """(N, 2) array of (op, length)."""
        return np.stack([self.cigar & 0xF, self.cigar >> 4], axis=1).astype(np.int64)

    def seq_nibbles(self) -> np.ndarray:
        """4-bit codes per base (len l_seq)."""
        packed = np.frombuffer(self.raw, dtype=np.uint8,
                               count=(self._l_seq + 1) // 2, offset=self._seq_off)
        out = np.empty(((self._l_seq + 1) // 2) * 2, dtype=np.uint8)
        out[0::2] = packed >> 4
        out[1::2] = packed & 0xF
        return out[:self._l_seq]

    def seq(self) -> str:
        return _SEQ_NT16[self.seq_nibbles()].tobytes().decode("ascii")

    def quals(self) -> Optional[np.ndarray]:
        q = np.frombuffer(self.raw, dtype=np.uint8, count=self._l_seq,
                          offset=self._qual_off)
        if self._l_seq > 0 and q[0] == 0xFF:
            return None  # quals unavailable (htsIntegration.c:1646)
        return q

    def tags_blob(self) -> bytes:
        return self.raw[self._tag_off:]

    def reference_span(self) -> int:
        ops = self.cigar_ops()
        return int(ops[_CONSUMES_REF[ops[:, 0]], 1].sum())


def parse_record(raw: bytes) -> BamRecord:
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     _nref, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", raw, 0)
    off = 32
    name = raw[off:off + l_read_name - 1].decode("ascii")
    off += l_read_name
    cigar = np.frombuffer(raw, dtype=np.uint32, count=n_cigar, offset=off)
    off += 4 * n_cigar
    seq_off = off
    off += (l_seq + 1) // 2
    qual_off = off
    off += l_seq
    return BamRecord(name, flag, ref_id, pos, mapq, cigar, raw,
                     l_seq, seq_off, qual_off, off)


class BamHeader:
    def __init__(self, text: str, ref_names: list, ref_lengths: list):
        self.text = text
        self.ref_names = ref_names
        self.ref_lengths = ref_lengths
        self._name_to_id = {n: i for i, n in enumerate(ref_names)}

    def ref_id(self, name: str) -> int:
        return self._name_to_id.get(name, -1)


class BamReader:
    """Sequential + indexed BAM reader."""

    def __init__(self, path: str):
        self.path = path
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path} is not a BAM file")
        l_text = struct.unpack("<i", self._bgzf.read(4))[0]
        text = self._bgzf.read(l_text).decode("ascii", "replace")
        n_ref = struct.unpack("<i", self._bgzf.read(4))[0]
        names, lengths = [], []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._bgzf.read(4))[0]
            names.append(self._bgzf.read(l_name)[:-1].decode("ascii"))
            lengths.append(struct.unpack("<i", self._bgzf.read(4))[0])
        self.header = BamHeader(text, names, lengths)
        self._data_voffset = self._bgzf.tell_virtual()
        self._index = None
        self._native = None       # lazily opened NativeBam for fetch()
        self._native_tried = False

    def close(self):
        self._bgzf.close()
        if self._native is not None:
            self._native.close()
            self._native = None
            self._native_tried = False

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def _read_record(self) -> Optional[BamRecord]:
        size_b = self._bgzf.read(4)
        if len(size_b) < 4:
            return None
        block_size = struct.unpack("<i", size_b)[0]
        raw = self._bgzf.read(block_size)
        if len(raw) < block_size:
            return None
        return parse_record(raw)

    def __iter__(self) -> Iterator[BamRecord]:
        self._bgzf.seek_virtual(self._data_voffset)
        while True:
            rec = self._read_record()
            if rec is None:
                return
            yield rec

    # -- indexed access ------------------------------------------------------

    def _load_index(self):
        if self._index is None:
            self._index = BaiIndex(self.path + ".bai")
        return self._index

    def _native_bam(self):
        """Native region iterator (marginio) when the library is built; the
        BGZF inflate + record framing then run in C with the GIL released.
        Same record set as the Python path (both mirror sam_itr_regions)."""
        if not self._native_tried:
            self._native_tried = True
            try:
                import os
                from margin_tpu_torch.io import native
                # without a .bai the native iterator would silently yield
                # nothing; let the Python path raise its usual error
                if native.lib() is not None and os.path.exists(
                        self.path + ".bai"):
                    self._native = native.NativeBam(self.path)
            except Exception:
                self._native = None
        return self._native

    def fetch(self, contig: str, start: int, end: int) -> Iterator[BamRecord]:
        """Yield records overlapping [start, end) on contig, like
        sam_itr_regions (reads whose alignment span intersects the window)."""
        rid = self.header.ref_id(contig)
        if rid < 0:
            return
        nb = self._native_bam()
        if nb is not None:
            for raw in nb.fetch_raw(rid, start, end):
                yield parse_record(raw)
            return
        idx = self._load_index()
        chunks = idx.query_chunks(rid, start, end)
        for beg, cend in chunks:
            self._bgzf.seek_virtual(beg)
            while self._bgzf.tell_virtual() < cend:
                rec = self._read_record()
                if rec is None:
                    break
                if rec.ref_id != rid:
                    if rec.ref_id > rid:
                        break
                    continue
                if rec.pos >= end:
                    break
                if rec.is_unmapped:
                    continue
                if rec.pos + max(rec.reference_span(), 1) > start:
                    yield rec


# -- BAI index ---------------------------------------------------------------

def _reg2bins(beg: int, end: int):
    """List of bins overlapping [beg, end) (SAM spec)."""
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


class BaiIndex:
    def __init__(self, path: str):
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"{path} is not a BAI index")
        off = 4
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        self.refs = []
        for _ in range(n_ref):
            n_bin = struct.unpack_from("<i", data, off)[0]
            off += 4
            bins = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = np.frombuffer(data, dtype=np.uint64, count=2 * n_chunk,
                                       offset=off).reshape(n_chunk, 2)
                off += 16 * n_chunk
                bins[bin_id] = chunks
            n_intv = struct.unpack_from("<i", data, off)[0]
            off += 4
            ioffsets = np.frombuffer(data, dtype=np.uint64, count=n_intv, offset=off)
            off += 8 * n_intv
            self.refs.append((bins, ioffsets))

    def query_chunks(self, rid: int, start: int, end: int):
        """Merged (beg, end) virtual-offset chunks overlapping the window."""
        if rid >= len(self.refs):
            return []
        bins, ioffsets = self.refs[rid]
        min_off = 0
        if len(ioffsets) > 0:
            i = min(start >> 14, len(ioffsets) - 1)
            min_off = int(ioffsets[i])
        chunks = []
        for b in _reg2bins(start, end):
            if b in bins:
                for beg, cend in bins[b]:
                    if int(cend) > min_off:
                        chunks.append((max(int(beg), min_off), int(cend)))
        chunks.sort()
        merged = []
        for beg, cend in chunks:
            if merged and beg <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], cend))
            else:
                merged.append((beg, cend))
        return merged


# -- writer ------------------------------------------------------------------

class BamWriter:
    def __init__(self, path: str, header: BamHeader):
        self._w = BgzfWriter(path)
        text = header.text.encode("ascii")
        out = bytearray(b"BAM\x01")
        out += struct.pack("<i", len(text))
        out += text
        out += struct.pack("<i", len(header.ref_names))
        for name, length in zip(header.ref_names, header.ref_lengths):
            nb = name.encode("ascii") + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._w.write(bytes(out))

    def write_raw(self, raw: bytes):
        self._w.write(struct.pack("<i", len(raw)) + raw)

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# -- tag editing (for HP haplotags) -----------------------------------------

_TAG_TYPE_SIZES = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
                   ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4}


def _iter_tags(blob: bytes):
    """Yield (tag, type_char, start, end) byte ranges within the tag blob."""
    off = 0
    n = len(blob)
    while off + 3 <= n:
        tag = blob[off:off + 2]
        typ = blob[off + 2]
        start = off
        off += 3
        if typ in _TAG_TYPE_SIZES:
            off += _TAG_TYPE_SIZES[typ]
        elif typ in (ord("Z"), ord("H")):
            while off < n and blob[off] != 0:
                off += 1
            off += 1
        elif typ == ord("B"):
            sub = blob[off]
            cnt = struct.unpack_from("<i", blob, off + 1)[0]
            off += 5 + _TAG_TYPE_SIZES[sub] * cnt
        else:
            raise ValueError(f"Unknown tag type {chr(typ)}")
        yield tag, typ, start, off


def set_hp_tag(raw: bytes, rec: BamRecord, haplotype: int) -> bytes:
    """Return record payload with HP:i set to haplotype (1/2), updated in
    place if present, appended otherwise; haplotype 0 removes any HP tag.
    Mirrors htsIntegration.c:1473-1481."""
    tag_off = rec._tag_off
    head, blob = raw[:tag_off], raw[tag_off:]
    pieces = []
    found = False
    for tag, typ, s, e in _iter_tags(blob):
        if tag == b"HP":
            found = True
            if haplotype != 0:
                pieces.append(b"HPi" + struct.pack("<i", haplotype))
            # haplotype == 0: drop the tag
        else:
            pieces.append(blob[s:e])
    if not found and haplotype != 0:
        pieces.append(b"HPi" + struct.pack("<i", haplotype))
    return head + b"".join(pieces)


def _reg2bin(beg: int, end: int) -> int:
    """SAM spec reg2bin: smallest bin containing [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def build_bai(bam_path: str, out_path: str = None) -> str:
    """Write a BAI index for a coordinate-sorted BAM (the binning +
    16kb-window linear index scheme BaiIndex reads)."""
    out_path = out_path or bam_path + ".bai"
    reader = BamReader(bam_path)
    n_ref = len(reader.header.ref_names)
    bins = [dict() for _ in range(n_ref)]      # bin -> [(beg_voff, end_voff)]
    linear = [dict() for _ in range(n_ref)]    # window -> min voff
    while True:
        voff_start = reader._bgzf.tell_virtual()
        rec = reader._read_record()
        if rec is None:
            break
        voff_end = reader._bgzf.tell_virtual()
        if rec.ref_id < 0 or rec.pos < 0:
            continue
        ops = rec.cigar_ops()
        ref_len = int(ops[np.isin(ops[:, 0], (0, 2, 3, 7, 8)), 1].sum()) \
            if len(ops) else 1
        beg, end = rec.pos, rec.pos + max(ref_len, 1)
        b = _reg2bin(beg, end)
        chunks = bins[rec.ref_id].setdefault(b, [])
        if chunks and chunks[-1][1] == voff_start:
            chunks[-1] = (chunks[-1][0], voff_end)  # merge adjacent
        else:
            chunks.append((voff_start, voff_end))
        for w in range(beg >> 14, ((end - 1) >> 14) + 1):
            cur = linear[rec.ref_id].get(w)
            if cur is None or voff_start < cur:
                linear[rec.ref_id][w] = voff_start
    reader.close()

    out = bytearray(b"BAI\x01")
    out += struct.pack("<i", n_ref)
    for rid in range(n_ref):
        out += struct.pack("<i", len(bins[rid]))
        for b, chunks in sorted(bins[rid].items()):
            out += struct.pack("<Ii", b, len(chunks))
            for beg_v, end_v in chunks:
                out += struct.pack("<QQ", beg_v, end_v)
        if linear[rid]:
            n_win = max(linear[rid]) + 1
            out += struct.pack("<i", n_win)
            prev = 0
            for w in range(n_win):
                v = linear[rid].get(w)
                if v is not None:
                    prev = v
                out += struct.pack("<Q", linear[rid].get(w, prev))
        else:
            out += struct.pack("<i", 0)
    with open(out_path, "wb") as fh:
        fh.write(bytes(out))
    return out_path


# ---------------------------------------------------------------------------
# format dispatch (BAM / CRAM)
# ---------------------------------------------------------------------------

_CRAM_REFERENCE: list = [None]


def set_cram_reference(fasta_path):
    """Register the reference FASTA used to decode CRAM inputs (drivers
    call this once; htsIntegration relies on htslib's ref handling)."""
    _CRAM_REFERENCE[0] = fasta_path


def is_cram(path: str) -> bool:
    if path.endswith(".cram"):
        return True
    try:
        with open(path, "rb") as fh:
            return fh.read(4) == b"CRAM"
    except OSError:
        return False


def open_alignment(path: str, reference=None):
    """Open a BAM or CRAM by content sniffing; CRAM decodes against the
    registered (or passed) reference FASTA. Both readers yield identical
    BamRecord objects (sam_open parity, htsIntegration.c)."""
    if is_cram(path):
        from margin_tpu_torch.io.cram import CramReader
        return CramReader(path, reference or _CRAM_REFERENCE[0])
    return BamReader(path)
