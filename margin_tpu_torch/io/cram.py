"""CRAM 3.0 reader/writer.

Parity: the reference reads CRAM transparently through htslib's
`sam_open`/`cram_*` (htsIntegration.c uses sam_open; htslib cram/ decodes
containers/slices).  This is a from-scratch implementation of the CRAM 3.0
specification (samtools/hts-specs CRAMv3): container/slice structure,
itf8/ltf8 varints, gzip + rANS-4x8 (order 0/1) block codecs, the
EXTERNAL / HUFFMAN / BETA / BYTE_ARRAY_LEN / BYTE_ARRAY_STOP encodings,
and full feature-based sequence reconstruction against the reference
FASTA.  Decoded records materialise standard BAM record payloads, so the
rest of the pipeline (read extraction, haplotagging) is format-agnostic.

The writer emits a deliberately simple-but-legal profile (every data
series in its own EXTERNAL block, gzip compression, detached mate info,
soft/hard-clip + indel + per-base 'B' mismatch features computed against
the reference) plus a `.crai` index; it exists for tests and for
BAM<->CRAM conversion without htslib.

Copy of `margin_tpu/io/cram.py` with the port's imports.
"""

from __future__ import annotations

import gzip
import hashlib
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from margin_tpu_torch.io.bam import BamHeader, BamRecord, parse_record

# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------


class ByteCursor:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def itf8(self) -> int:
        b0 = self.u8()
        if b0 < 0x80:
            v = b0
        elif b0 < 0xC0:
            v = ((b0 & 0x3F) << 8) | self.u8()
        elif b0 < 0xE0:
            v = ((b0 & 0x1F) << 16) | (self.u8() << 8) | self.u8()
        elif b0 < 0xF0:
            v = ((b0 & 0x0F) << 24) | (self.u8() << 16) \
                | (self.u8() << 8) | self.u8()
        else:
            v = ((b0 & 0x0F) << 28) | (self.u8() << 20) | (self.u8() << 12) \
                | (self.u8() << 4) | (self.u8() & 0x0F)
        if v >= 1 << 31:
            v -= 1 << 32
        return v

    def ltf8(self) -> int:
        b0 = self.u8()
        n_extra = 0
        mask = b0
        while n_extra < 8 and (mask & 0x80):
            n_extra += 1
            mask = (mask << 1) & 0xFF
        if n_extra == 0:
            v = b0
        else:
            prefix_bits = 8 - n_extra - (1 if n_extra < 8 else 0)
            v = b0 & ((1 << prefix_bits) - 1) if n_extra < 8 else 0
            for _ in range(n_extra):
                v = (v << 8) | self.u8()
        if v >= 1 << 63:
            v -= 1 << 64
        return v

    def itf8_array(self) -> List[int]:
        return [self.itf8() for _ in range(self.itf8())]


def write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF,
                      (v >> 8) & 0xFF, v & 0xFF])
    return bytes([0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                  (v >> 4) & 0xFF, v & 0x0F])


def write_ltf8(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    out = []
    n = v
    nbytes = 0
    while n:
        nbytes += 1
        n >>= 8
    # choose the canonical smallest representation
    for extra in range(1, 9):
        prefix_bits = 8 - extra - (1 if extra < 8 else 0)
        if extra == 8 or v < (1 << (prefix_bits + 8 * extra)):
            lead = (0xFF << (8 - extra)) & 0xFF
            if extra < 8:
                lead |= (v >> (8 * extra)) & ((1 << prefix_bits) - 1)
            out.append(lead)
            for i in range(extra - 1, -1, -1):
                out.append((v >> (8 * i)) & 0xFF)
            return bytes(out)
    raise AssertionError


def write_itf8_array(vals: List[int]) -> bytes:
    return write_itf8(len(vals)) + b"".join(write_itf8(v) for v in vals)


# ---------------------------------------------------------------------------
# rANS 4x8 decoder (CRAM 3.0 codec id 4)
# ---------------------------------------------------------------------------

_RANS_LOW = 1 << 23


def _read_freq_table0(cur: ByteCursor):
    """Order-0 frequency table: symbol + optional RLE, freqs as itf8,
    terminated by symbol 0."""
    freqs = np.zeros(256, dtype=np.uint32)
    sym = cur.u8()
    last_sym = sym
    rle = 0
    while True:
        freqs[sym] = cur.itf8()
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            nxt = cur.u8()
            if nxt == 0:
                break
            if nxt == last_sym + 1:
                rle = cur.u8()
            last_sym = nxt
            sym = nxt
    cum = np.zeros(257, dtype=np.uint32)
    cum[1:] = np.cumsum(freqs)
    return freqs, cum


def _rans_decode_0(cur: ByteCursor, out_len: int) -> bytes:
    freqs, cum = _read_freq_table0(cur)
    # symbol lookup per 12-bit slot
    slot2sym = np.zeros(4096, dtype=np.uint8)
    for s in range(256):
        if freqs[s]:
            slot2sym[cum[s]:cum[s] + freqs[s]] = s
    states = [struct.unpack("<I", cur.read(4))[0] for _ in range(4)]
    out = bytearray(out_len)
    data = cur.data
    pos = cur.pos
    f = freqs
    c = cum
    for i in range(out_len):
        j = i & 3
        x = states[j]
        slot = x & 0xFFF
        s = slot2sym[slot]
        out[i] = s
        x = int(f[s]) * (x >> 12) + slot - int(c[s])
        while x < _RANS_LOW:
            x = (x << 8) | data[pos]
            pos += 1
        states[j] = x
    cur.pos = pos
    return bytes(out)


def _rans_decode_1(cur: ByteCursor, out_len: int) -> bytes:
    """Order-1: 256 context tables, 4 interleaved streams each decoding a
    quarter of the output."""
    freqs = np.zeros((256, 256), dtype=np.uint32)
    cums = np.zeros((256, 257), dtype=np.uint32)
    ctx = cur.u8()
    last_ctx = ctx
    rle_ctx = 0
    while True:
        f, c = _read_freq_table0(cur)
        freqs[ctx] = f
        cums[ctx] = c
        if rle_ctx > 0:
            rle_ctx -= 1
            ctx += 1
        else:
            nxt = cur.u8()
            if nxt == 0:
                break
            if nxt == last_ctx + 1:
                rle_ctx = cur.u8()
            last_ctx = nxt
            ctx = nxt
    slot2sym = np.zeros((256, 4096), dtype=np.uint8)
    for cx in range(256):
        fr = freqs[cx]
        cm = cums[cx]
        nz = np.nonzero(fr)[0]
        for s in nz:
            slot2sym[cx, cm[s]:cm[s] + fr[s]] = s
    states = [struct.unpack("<I", cur.read(4))[0] for _ in range(4)]
    out = bytearray(out_len)
    data = cur.data
    pos = cur.pos
    q = out_len >> 2
    ctxs = [0, 0, 0, 0]
    idx = [0, q, 2 * q, 3 * q]
    for _ in range(q):
        for j in range(4):
            x = states[j]
            cx = ctxs[j]
            slot = x & 0xFFF
            s = int(slot2sym[cx, slot])
            out[idx[j]] = s
            x = int(freqs[cx, s]) * (x >> 12) + slot - int(cums[cx, s])
            while x < _RANS_LOW:
                x = (x << 8) | data[pos]
                pos += 1
            states[j] = x
            ctxs[j] = s
            idx[j] += 1
    # stream 3 handles the ragged tail sequentially
    j = 3
    while idx[j] < out_len:
        x = states[j]
        cx = ctxs[j]
        slot = x & 0xFFF
        s = int(slot2sym[cx, slot])
        out[idx[j]] = s
        x = int(freqs[cx, s]) * (x >> 12) + slot - int(cums[cx, s])
        while x < _RANS_LOW:
            x = (x << 8) | data[pos]
            pos += 1
        states[j] = x
        ctxs[j] = s
        idx[j] += 1
    cur.pos = pos
    return bytes(out)


def rans_decode(data: bytes, raw_size: int) -> bytes:
    cur = ByteCursor(data)
    order = cur.u8()
    cur.itf8()  # compressed size (unused)
    n_out = cur.itf8()
    assert n_out == raw_size, (n_out, raw_size)
    if order == 0:
        return _rans_decode_0(cur, n_out)
    return _rans_decode_1(cur, n_out)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

RAW, GZIP, BZIP2, LZMA, RANS = range(5)
CT_FILE_HEADER, CT_COMPRESSION_HEADER, CT_SLICE_HEADER = 0, 1, 2
CT_EXTERNAL, CT_CORE = 4, 5


@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes  # uncompressed


def read_block(cur: ByteCursor) -> Block:
    method = cur.u8()
    ctype = cur.u8()
    cid = cur.itf8()
    comp_size = cur.itf8()
    raw_size = cur.itf8()
    payload = cur.read(comp_size)
    cur.read(4)  # crc32
    if method == RAW:
        data = payload
    elif method == GZIP:
        data = gzip.decompress(payload)
    elif method == BZIP2:
        import bz2
        data = bz2.decompress(payload)
    elif method == LZMA:
        import lzma
        data = lzma.decompress(payload)
    elif method == RANS:
        data = rans_decode(payload, raw_size)
    else:
        raise ValueError(f"unsupported CRAM block method {method}")
    assert len(data) == raw_size, (len(data), raw_size)
    return Block(method, ctype, cid, data)


def write_block(method: int, ctype: int, cid: int, data: bytes) -> bytes:
    if method == GZIP:
        payload = gzip.compress(data, 6)
    else:
        payload = data
    out = bytes([method, ctype]) + write_itf8(cid) \
        + write_itf8(len(payload)) + write_itf8(len(data)) + payload
    return out + struct.pack("<I", zlib.crc32(out))


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------

E_NULL, E_EXTERNAL, E_GOLOMB, E_HUFFMAN = 0, 1, 2, 3
E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP, E_BETA = 4, 5, 6


class BitReader:
    __slots__ = ("data", "pos", "bit")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 7

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.data[self.pos] >> self.bit) & 1)
            if self.bit == 0:
                self.bit = 7
                self.pos += 1
            else:
                self.bit -= 1
        return v


@dataclass
class Encoding:
    codec: int
    params: bytes

    def make_reader(self, external: Dict[int, ByteCursor], core: BitReader):
        """Returns fn(kind) where kind is 'int', 'byte' or 'bytes'."""
        cur = ByteCursor(self.params)
        if self.codec == E_EXTERNAL:
            cid = cur.itf8()

            def rd_int():
                return external[cid].itf8()

            def rd_byte():
                return external[cid].u8()

            def rd_bytes(n):
                return external[cid].read(n)

            return rd_int, rd_byte, rd_bytes
        if self.codec == E_HUFFMAN:
            alphabet = cur.itf8_array()
            lengths = cur.itf8_array()
            if len(alphabet) == 1 and lengths[0] == 0:
                v = alphabet[0]
                return (lambda: v), (lambda: v), None
            # canonical codes ordered by (length, symbol order as given)
            order = sorted(range(len(alphabet)),
                           key=lambda i: (lengths[i], i))
            codes = {}
            code = 0
            prev_len = 0
            for i in order:
                code <<= (lengths[i] - prev_len)
                prev_len = lengths[i]
                codes[(lengths[i], code)] = alphabet[i]
                code += 1

            def rd_huff():
                length = 0
                code_v = 0
                while True:
                    code_v = (code_v << 1) | core.read_bits(1)
                    length += 1
                    if (length, code_v) in codes:
                        return codes[(length, code_v)]

            return rd_huff, rd_huff, None
        if self.codec == E_BETA:
            offset = cur.itf8()
            nbits = cur.itf8()

            def rd_beta():
                return core.read_bits(nbits) + offset

            return rd_beta, rd_beta, None
        if self.codec == E_BYTE_ARRAY_STOP:
            stop = cur.u8()
            cid = cur.itf8()

            def rd_arr_stop(_n=None):
                ext = external[cid]
                end = ext.data.index(stop, ext.pos)
                out = ext.data[ext.pos:end]
                ext.pos = end + 1
                return out

            return None, None, rd_arr_stop
        if self.codec == E_BYTE_ARRAY_LEN:
            len_codec = cur.itf8()
            len_params = cur.read(cur.itf8())
            val_codec = cur.itf8()
            val_params = cur.read(cur.itf8())
            len_enc = Encoding(len_codec, len_params)
            val_enc = Encoding(val_codec, val_params)

            li_r = len_enc.make_reader(external, core)
            vb_r = val_enc.make_reader(external, core)

            def rd_arr_len_fast(_n=None):
                n = li_r[0]()
                return vb_r[2](n)

            return None, None, rd_arr_len_fast
        raise ValueError(f"unsupported CRAM encoding codec {self.codec}")


def read_encoding(cur: ByteCursor) -> Encoding:
    codec = cur.itf8()
    params = cur.read(cur.itf8())
    return Encoding(codec, params)


def enc_external(cid: int) -> bytes:
    p = write_itf8(cid)
    return write_itf8(E_EXTERNAL) + write_itf8(len(p)) + p


def enc_byte_array_len_ext(len_cid: int, val_cid: int) -> bytes:
    lp = write_itf8(len_cid)
    vp = write_itf8(val_cid)
    p = (write_itf8(E_EXTERNAL) + write_itf8(len(lp)) + lp
         + write_itf8(E_EXTERNAL) + write_itf8(len(vp)) + vp)
    return write_itf8(E_BYTE_ARRAY_LEN) + write_itf8(len(p)) + p


def enc_byte_array_stop(stop: int, cid: int) -> bytes:
    p = bytes([stop]) + write_itf8(cid)
    return write_itf8(E_BYTE_ARRAY_STOP) + write_itf8(len(p)) + p


# ---------------------------------------------------------------------------
# compression header
# ---------------------------------------------------------------------------


@dataclass
class CompressionHeader:
    rn_preserved: bool = True
    ap_delta: bool = True
    rr: bool = True
    subst_matrix: bytes = b"\x00" * 5
    tag_dict: List[List[bytes]] = field(default_factory=list)
    data_series: Dict[bytes, Encoding] = field(default_factory=dict)
    tag_encodings: Dict[int, Encoding] = field(default_factory=dict)


def parse_compression_header(data: bytes) -> CompressionHeader:
    cur = ByteCursor(data)
    ch = CompressionHeader()
    # preservation map
    cur.itf8()  # size in bytes
    for _ in range(cur.itf8()):
        key = cur.read(2)
        if key == b"RN":
            ch.rn_preserved = bool(cur.u8())
        elif key == b"AP":
            ch.ap_delta = bool(cur.u8())
        elif key == b"RR":
            ch.rr = bool(cur.u8())
        elif key == b"SM":
            ch.subst_matrix = cur.read(5)
        elif key == b"TD":
            blob = cur.read(cur.itf8())
            lines = blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") \
                else blob.split(b"\x00")
            ch.tag_dict = [[ln[i:i + 3] for i in range(0, len(ln), 3)]
                           for ln in lines]
        else:
            raise ValueError(f"unknown preservation key {key}")
    # data series encodings
    cur.itf8()
    for _ in range(cur.itf8()):
        key = cur.read(2)
        ch.data_series[key] = read_encoding(cur)
    # tag encodings
    cur.itf8()
    for _ in range(cur.itf8()):
        key = cur.itf8()
        ch.tag_encodings[key] = read_encoding(cur)
    return ch


# ---------------------------------------------------------------------------
# substitution matrix (X features)
# ---------------------------------------------------------------------------

_BASES = b"ACGTN"


def subst_decode(matrix: bytes, ref_base: int, code: int) -> int:
    """CRAM SM: per reference base, a ranking of the other 4 bases packed
    2 bits each (most significant first)."""
    r = _BASES.index(ref_base) if ref_base in _BASES else 4
    packed = matrix[r]
    others = [b for b in _BASES if b != (ref_base if ref_base in _BASES
                                         else _BASES[r])]
    for b in others:
        rank = (packed >> 6) & 0x3
        if rank == code:
            return b
        packed = (packed << 2) & 0xFF
    # fallback: identity
    return ref_base


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

_NT16 = {c: i for i, c in enumerate(b"=ACMGRSVTWYHKDBN")}


def _pack_seq(seq: bytes) -> bytes:
    out = bytearray((len(seq) + 1) // 2)
    for i, b in enumerate(seq):
        code = _NT16.get(b, 15)
        if i % 2 == 0:
            out[i // 2] = code << 4
        else:
            out[i // 2] |= code
    return bytes(out)


def build_bam_record(name: str, flag: int, ref_id: int, pos: int, mapq: int,
                     cigar: List[Tuple[int, int]], seq: bytes,
                     quals: Optional[bytes], tags: bytes,
                     mate_ref_id: int = -1, mate_pos: int = -1,
                     tlen: int = 0) -> BamRecord:
    """Materialize a BAM-format payload (bam.py parse_record layout)."""
    name_b = name.encode() + b"\x00"
    cigar_b = b"".join(struct.pack("<I", (ln << 4) | op) for op, ln in cigar)
    seq_b = _pack_seq(seq)
    qual_b = quals if quals is not None else b"\xff" * len(seq)
    raw = struct.pack("<iiBBHHHiiii", ref_id, pos, len(name_b), mapq, 0,
                      len(cigar), flag, len(seq), mate_ref_id, mate_pos,
                      tlen) + name_b + cigar_b + seq_b + qual_b + tags
    return parse_record(raw)


_CODE2OP = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6}


class CramReader:
    """Iterate CRAM records as BamRecord objects.

    `reference` is the path to the reference FASTA (required unless every
    slice embeds its reference or all reads are unmapped)."""

    def __init__(self, path: str, reference: Optional[str] = None):
        import mmap
        self.path = path
        self._fh = open(path, "rb")
        # mmap: per-thread readers share pages instead of each slurping
        # the file, and region queries only touch the containers they skip
        # to (headers) or decode
        self._data = mmap.mmap(self._fh.fileno(), 0,
                               access=mmap.ACCESS_READ)
        if self._data[:4] != b"CRAM":
            raise ValueError(f"{path} is not a CRAM file")
        self.major, self.minor = self._data[4], self._data[5]
        if self.major != 3:
            raise ValueError(f"unsupported CRAM version {self.major}")
        cur = ByteCursor(self._data, 26)
        # SAM header container (skip any padding blocks via the length)
        hdr0 = self._container_header(cur)
        blocks_start = cur.pos
        hdr_block = read_block(cur)
        cur.pos = blocks_start + hdr0[0]
        text_len = struct.unpack("<i", hdr_block.data[:4])[0]
        text = hdr_block.data[4:4 + text_len].decode("ascii", "replace")
        names, lengths = [], []
        for line in text.splitlines():
            if line.startswith("@SQ"):
                d = dict(f.split(":", 1) for f in line.split("\t")[1:]
                         if ":" in f)
                names.append(d.get("SN", ""))
                lengths.append(int(d.get("LN", 0)))
        self.header = BamHeader(text, names, lengths)
        self._first_container = cur.pos
        # skip remaining header-container blocks (padding)
        self._ref_path = reference
        self._ref_cache: Dict[int, bytes] = {}

    def close(self):
        try:
            self._data.close()
        except (AttributeError, ValueError):
            pass
        self._data = b""
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # -- low level ---------------------------------------------------------

    def _container_header(self, cur: ByteCursor):
        length = struct.unpack("<i", cur.read(4))[0]
        ref_id = cur.itf8()
        start = cur.itf8()
        span = cur.itf8()
        n_records = cur.itf8()
        counter = cur.ltf8()
        bases = cur.ltf8()
        n_blocks = cur.itf8()
        landmarks = cur.itf8_array()
        cur.read(4)  # crc
        return (length, ref_id, start, span, n_records, counter, bases,
                n_blocks, landmarks)

    def _ref_seq(self, ref_id: int) -> bytes:
        if ref_id in self._ref_cache:
            return self._ref_cache[ref_id]
        if self._ref_path is None:
            raise ValueError("CRAM decoding requires the reference FASTA")
        from margin_tpu_torch.io.fasta import FastaIndex
        fa = FastaIndex(self._ref_path)
        name = self.header.ref_names[ref_id]
        seq = fa.fetch(name, 0, fa.length(name)).upper().encode("ascii")
        self._ref_cache[ref_id] = seq
        return seq

    # -- record iteration --------------------------------------------------

    def __iter__(self):
        return self._iter_records(None)

    def _iter_records(self, region):
        """region: (ref_id, start, end) 0-based half-open or None; whole
        containers outside the region are skipped from their headers (the
        .crai carries the same info; headers avoid a sidecar dependency)."""
        cur = ByteCursor(self._data, self._first_container)
        while cur.pos < len(self._data):
            hdr = self._container_header(cur)
            length, ref_id, start = hdr[0], hdr[1], hdr[2]
            if ref_id == -1 and start == 4542278:
                break  # EOF container (spec magic position)
            end = cur.pos + length
            if hdr[7] == 0 or hdr[4] == 0:
                cur.pos = end
                continue
            if region is not None and ref_id >= 0:
                # skip containers that cannot overlap (multi-ref = -2 and
                # unmapped = -1 containers always decode)
                c_start = start - 1
                c_end = c_start + max(hdr[3], 0)
                if (ref_id != region[0] or c_start >= region[2]
                        or c_end <= region[1]):
                    cur.pos = end
                    continue
            comp_block = read_block(cur)
            ch = parse_compression_header(comp_block.data)
            while cur.pos < end:
                blk = read_block(cur)
                if blk.content_type != CT_SLICE_HEADER:
                    continue
                yield from self._decode_slice(blk, ch, cur)
            cur.pos = end

    def fetch(self, contig: str, start: int, end: int):
        """Region query (0-based half-open): linear container scan with
        header-level skipping of non-overlapping containers."""
        rid = self.header.ref_id(contig)
        for rec in self._iter_records((rid, start, end)):
            if rec.ref_id != rid or rec.is_unmapped:
                continue
            if rec.pos >= end:
                continue
            if rec.pos + rec.reference_span() <= start:
                continue
            yield rec

    def _decode_slice(self, slice_blk: Block, ch: CompressionHeader,
                      cur: ByteCursor):
        sh = ByteCursor(slice_blk.data)
        ref_id = sh.itf8()
        aln_start = sh.itf8()
        sh.itf8()  # span
        n_records = sh.itf8()
        sh.ltf8()  # counter
        n_blocks = sh.itf8()
        sh.itf8_array()  # content ids
        embedded_ref_cid = sh.itf8()
        sh.read(16)  # md5
        core_data = b""
        external: Dict[int, ByteCursor] = {}
        embedded_ref = None
        for _ in range(n_blocks):
            blk = read_block(cur)
            if blk.content_type == CT_CORE:
                core_data = blk.data
            else:
                external[blk.content_id] = ByteCursor(blk.data)
                if blk.content_id == embedded_ref_cid >= 0:
                    embedded_ref = blk.data
        core = BitReader(core_data)

        def reader(key: bytes):
            enc = ch.data_series.get(key)
            if enc is None:
                return None
            return enc.make_reader(external, core)

        rd = {k: reader(k) for k in
              (b"BF", b"CF", b"RI", b"RL", b"AP", b"RG", b"RN", b"MF",
               b"NS", b"NP", b"TS", b"NF", b"TL", b"FN", b"FC", b"FP",
               b"DL", b"BA", b"BS", b"IN", b"SC", b"RS", b"PD", b"HC",
               b"MQ", b"QS", b"BB", b"QQ")}
        tag_readers = {k: e.make_reader(external, core)
                       for k, e in ch.tag_encodings.items()}

        if ref_id >= 0:
            ref = (embedded_ref if embedded_ref is not None
                   else self._ref_seq(ref_id))
            ref_off = 0 if embedded_ref is None else aln_start - 1
        else:
            ref, ref_off = b"", 0

        prev_ap = aln_start
        out_recs = []
        mate_links = []  # (record idx, NF distance) for within-slice mates
        for _ in range(n_records):
            bf = rd[b"BF"][0]()
            cf = rd[b"CF"][0]()
            rid = rd[b"RI"][0]() if ref_id == -2 else ref_id
            rl = rd[b"RL"][0]()
            ap = rd[b"AP"][0]()
            if ch.ap_delta:
                ap += prev_ap
                prev_ap = ap
            rd[b"RG"][0]()
            name = ""
            if ch.rn_preserved:
                name = rd[b"RN"][2]().decode("ascii")
            mate_rid, mate_pos, tlen = -1, -1, 0
            flag = bf
            if cf & 0x2:  # detached
                mf = rd[b"MF"][0]()
                if not ch.rn_preserved:
                    name = rd[b"RN"][2]().decode("ascii")
                mate_rid = rd[b"NS"][0]()
                mate_pos = rd[b"NP"][0]() - 1
                tlen = rd[b"TS"][0]()
                if mf & 0x1:
                    flag |= 0x20
                if mf & 0x2:
                    flag |= 0x8
            elif cf & 0x4:
                mate_links.append((len(out_recs), rd[b"NF"][0]()))
            tl = rd[b"TL"][0]()
            tags = bytearray()
            if 0 <= tl < len(ch.tag_dict):
                for tag3 in ch.tag_dict[tl]:
                    key = (tag3[0] << 16) | (tag3[1] << 8) | tag3[2]
                    val = tag_readers[key][2]()
                    tags += tag3 + val
            if not (bf & 0x4):  # mapped
                rec = self._decode_mapped(
                    rd, ch, cf, rl, ap, ref, ref_off, name, flag, rid,
                    mate_rid, mate_pos, tlen, bytes(tags))
            else:
                bases = bytes(rd[b"BA"][1]() for _ in range(rl))
                quals = (bytes(rd[b"QS"][1]() for _ in range(rl))
                         if cf & 0x1 else None)
                rec = build_bam_record(name, flag, rid, ap - 1, 0, [],
                                       bases, quals, bytes(tags),
                                       mate_rid, mate_pos, tlen)
            out_recs.append(rec)
        # within-slice mates (CF & 0x4 + NF distance): fill mate fields and
        # derived flag bits the way htslib's cram decoder does
        for i, nf in mate_links:
            j = i + nf + 1
            if not (0 <= j < len(out_recs)):
                continue
            a, b = out_recs[i], out_recs[j]
            flag = a.flag
            if b.flag & 0x10:
                flag |= 0x20
            if b.flag & 0x4:
                flag |= 0x8
            a_end = a.pos + max(1, a.reference_span())
            b_end = b.pos + max(1, b.reference_span())
            if a.pos <= b.pos:
                tlen = max(a_end, b_end) - a.pos
            else:
                tlen = -(max(a_end, b_end) - b.pos)
            out_recs[i] = build_bam_record(
                a.name, flag, a.ref_id, a.pos, a.mapq,
                [(int(o), int(ln)) for o, ln in a.cigar_ops()],
                a.seq().encode(), None if a.quals() is None
                else bytes(bytearray(a.quals())), a.tags_blob(),
                b.ref_id, b.pos, tlen)
        yield from out_recs

    def _decode_mapped(self, rd, ch, cf, rl, ap, ref, ref_off, name, flag,
                       rid, mate_rid, mate_pos, tlen, tags):
        fn = rd[b"FN"][0]()
        seq = bytearray()
        cigar: List[Tuple[int, int]] = []
        feat_quals: Dict[int, int] = {}

        def add_cigar(op, ln):
            if ln <= 0:
                return
            if cigar and cigar[-1][0] == op:
                cigar[-1] = (op, cigar[-1][1] + ln)
            else:
                cigar.append((op, ln))

        read_pos = 0   # 1-based position within the read of last feature
        ref_pos = ap   # 1-based reference position of next match base
        prev_fp = 0
        for _ in range(fn):
            fc = chr(rd[b"FC"][1]())
            fp = rd[b"FP"][0]() + prev_fp
            prev_fp = fp
            # copy matched bases before this feature
            gap = fp - read_pos - 1
            if gap > 0:
                seq += ref[ref_pos - 1 - ref_off:
                           ref_pos - 1 - ref_off + gap]
                add_cigar(0, gap)
                ref_pos += gap
                read_pos += gap
            if fc == "X":
                code = rd[b"BS"][0]()
                ref_b = ref[ref_pos - 1 - ref_off]
                seq.append(subst_decode(ch.subst_matrix, ref_b, code))
                add_cigar(0, 1)
                ref_pos += 1
                read_pos += 1
            elif fc == "S":
                sc = rd[b"SC"][2]()
                seq += sc
                add_cigar(4, len(sc))
                read_pos += len(sc)
            elif fc == "I":
                ins = rd[b"IN"][2]()
                seq += ins
                add_cigar(1, len(ins))
                read_pos += len(ins)
            elif fc == "i":
                seq.append(rd[b"BA"][1]())
                add_cigar(1, 1)
                read_pos += 1
            elif fc == "D":
                dl = rd[b"DL"][0]()
                add_cigar(2, dl)
                ref_pos += dl
            elif fc == "N":
                rs = rd[b"RS"][0]()
                add_cigar(3, rs)
                ref_pos += rs
            elif fc == "P":
                add_cigar(6, rd[b"PD"][0]())
            elif fc == "H":
                add_cigar(5, rd[b"HC"][0]())
            elif fc == "B":
                seq.append(rd[b"BA"][1]())
                feat_quals[read_pos] = rd[b"QS"][1]()
                add_cigar(0, 1)
                ref_pos += 1
                read_pos += 1
            elif fc == "Q":
                feat_quals[read_pos] = rd[b"QS"][1]()
            elif fc == "b":
                bb = rd[b"BB"][2]()
                seq += bb
                add_cigar(0, len(bb))
                ref_pos += len(bb)
                read_pos += len(bb)
            elif fc == "q":
                qq = rd[b"QQ"][2]()
                for i, qv in enumerate(qq):
                    feat_quals[read_pos + i] = qv
            else:
                raise ValueError(f"unknown CRAM feature code {fc!r}")
        # trailing matches
        gap = rl - read_pos
        if gap > 0:
            seq += ref[ref_pos - 1 - ref_off:ref_pos - 1 - ref_off + gap]
            add_cigar(0, gap)
        mq = rd[b"MQ"][0]()
        quals = None
        if cf & 0x1:
            quals = bytes(rd[b"QS"][1]() for _ in range(rl))
        elif feat_quals:
            # selective qualities carried by B/Q/q features
            q = bytearray(b"\xff" * rl)
            for pos0, qv in feat_quals.items():
                if 0 <= pos0 < rl:
                    q[pos0] = qv
            quals = bytes(q)
        return build_bam_record(name, flag, rid, ap - 1, mq, cigar,
                                bytes(seq), quals, tags, mate_rid,
                                mate_pos, tlen)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_SERIES_INT = [b"BF", b"CF", b"RL", b"AP", b"RG", b"MF", b"NS", b"NP",
               b"TS", b"TL", b"FN", b"FP", b"DL", b"RS", b"PD", b"HC",
               b"MQ", b"BS"]
_SERIES_BYTE = [b"FC", b"BA", b"QS"]
_SERIES_ARR = [b"RN", b"IN", b"SC", b"BB", b"QQ"]

_SEQ_NT16_STR = "=ACMGRSVTWYHKDBN"


class CramWriter:
    """Minimal-profile CRAM 3.0 writer: one slice per container, every
    data series EXTERNAL+gzip, detached mates, mismatches as 'B' features
    (no substitution matrix needed), absolute AP.  Emits `.crai`."""

    def __init__(self, path: str, header: BamHeader,
                 reference: Optional[str], records_per_slice: int = 4096):
        self.path = path
        self.header = header
        self._ref_path = reference
        self._n = records_per_slice
        self._buf: List[BamRecord] = []
        self._fh = open(path, "wb")
        self._crai: List[Tuple[int, int, int, int, int, int]] = []
        self._counter = 0
        self._ref_cache: Dict[int, bytes] = {}
        self._fh.write(b"CRAM" + bytes([3, 0])
                       + hashlib.md5(path.encode()).digest()[:20].ljust(20, b"\x00")[:20])
        text = header.text
        if "@HD" not in text:
            text = "@HD\tVN:1.6\n" + text
        blob = struct.pack("<i", len(text)) + text.encode()
        blk = write_block(GZIP, CT_FILE_HEADER, 0, blob)
        self._write_container(blk, ref_id=0, start=0, span=0, n_records=0,
                              bases=0, landmarks=[0], n_blocks=1)

    def _ref_seq(self, ref_id: int) -> bytes:
        if ref_id not in self._ref_cache:
            from margin_tpu_torch.io.fasta import FastaIndex
            fa = FastaIndex(self._ref_path)
            name = self.header.ref_names[ref_id]
            self._ref_cache[ref_id] = fa.fetch(
                name, 0, fa.length(name)).upper().encode("ascii")
        return self._ref_cache[ref_id]

    def _write_container(self, blocks: bytes, ref_id, start, span,
                         n_records, bases, landmarks, n_blocks):
        hdr = (write_itf8(ref_id) + write_itf8(start) + write_itf8(span)
               + write_itf8(n_records) + write_ltf8(self._counter)
               + write_ltf8(bases) + write_itf8(n_blocks)
               + write_itf8_array(landmarks))
        # container length counts the blocks payload
        out = struct.pack("<i", len(blocks)) + hdr
        out += struct.pack("<I", zlib.crc32(out))
        off = self._fh.tell()
        self._fh.write(out + blocks)
        return off

    def write(self, rec: BamRecord):
        # a slice holds one reference sequence (or only-unmapped records):
        # flush at contig boundaries so multi-contig BAMs keep their
        # per-record ref assignment (the slice header carries ONE ref id)
        if self._buf and rec.ref_id != self._buf[0].ref_id:
            self._flush_slice()
        self._buf.append(rec)
        if len(self._buf) >= self._n:
            self._flush_slice()

    def _flush_slice(self):
        if not self._buf:
            return
        recs = self._buf
        self._buf = []
        series: Dict[bytes, bytearray] = {k: bytearray() for k in
                                          _SERIES_INT + _SERIES_BYTE
                                          + _SERIES_ARR}

        def put_int(key, v):
            series[key] += write_itf8(v)

        def put_byte(key, v):
            series[key].append(v & 0xFF)

        def put_arr(key, b):
            series[key] += write_itf8(len(b)) + b

        tag_lines: List[bytes] = []
        tag_line_idx: Dict[bytes, int] = {}
        tag_series: Dict[bytes, bytearray] = {}
        ref_id = recs[0].ref_id
        if ref_id < 0:
            starts = [0]
            ends = [0]
        else:
            starts = [r.pos + 1 for r in recs]
            ends = [r.pos + max(1, r.reference_span()) for r in recs]
        ref = self._ref_seq(ref_id) if ref_id >= 0 and self._ref_path \
            else b""
        n_bases = 0
        from margin_tpu_torch.io.bam import _iter_tags
        for rec in recs:
            seq = rec.seq().upper().encode("ascii")
            n_bases += len(seq)
            quals = rec.quals()
            has_quals = quals is not None
            cf = 0x2 | (0x1 if has_quals else 0)  # detached, quals stored
            put_int(b"BF", rec.flag)
            put_int(b"CF", cf)
            put_int(b"RL", len(seq))
            put_int(b"AP", rec.pos + 1)
            put_int(b"RG", -1)
            put_arr(b"RN", rec.name.encode())
            (mrid, mpos, tlen) = struct.unpack_from("<iii", rec.raw, 20)
            mf = ((0x1 if rec.flag & 0x20 else 0)
                  | (0x2 if rec.flag & 0x8 else 0))
            put_int(b"MF", mf)
            put_int(b"NS", mrid)
            put_int(b"NP", mpos + 1)
            put_int(b"TS", tlen)
            # tags
            blob = rec.tags_blob()
            items = []
            line = bytearray()
            for tag, typ, s, e in _iter_tags(blob):
                tag3 = bytes(tag) + bytes([typ])
                line += tag3
                items.append((tag3, blob[s + 3:e]))
            line_b = bytes(line)
            if line_b not in tag_line_idx:
                tag_line_idx[line_b] = len(tag_lines)
                tag_lines.append(line_b)
            put_int(b"TL", tag_line_idx[line_b])
            for tag3, val in items:
                tag_series.setdefault(tag3, bytearray())
                tag_series[tag3] += write_itf8(len(val)) + val
            if rec.flag & 0x4:
                for b in seq:
                    put_byte(b"BA", b)
                if has_quals:
                    for q in quals:
                        put_byte(b"QS", int(q))
                continue
            # features from CIGAR + reference comparison
            feats = []
            rpos = 0
            gpos = rec.pos
            for op, ln in rec.cigar_ops():
                op, ln = int(op), int(ln)
                if op in (0, 7, 8):  # M/=/X
                    for i in range(ln):
                        rb = ref[gpos + i] if gpos + i < len(ref) else 78
                        qb = seq[rpos + i]
                        if qb != rb:
                            feats.append(("B", rpos + i + 1,
                                          (qb, int(quals[rpos + i])
                                           if has_quals else 30)))
                    rpos += ln
                    gpos += ln
                elif op == 1:
                    feats.append(("I", rpos + 1, seq[rpos:rpos + ln]))
                    rpos += ln
                elif op == 4:
                    feats.append(("S", rpos + 1, seq[rpos:rpos + ln]))
                    rpos += ln
                elif op == 2:
                    feats.append(("D", rpos + 1, ln))
                    gpos += ln
                elif op == 3:
                    feats.append(("N", rpos + 1, ln))
                    gpos += ln
                elif op == 5:
                    feats.append(("H", rpos + 1, ln))
                elif op == 6:
                    feats.append(("P", rpos + 1, ln))
            put_int(b"FN", len(feats))
            prev_fp = 0
            for fc, fp, payload in feats:
                put_byte(b"FC", ord(fc))
                put_int(b"FP", fp - prev_fp)
                prev_fp = fp
                if fc == "B":
                    put_byte(b"BA", payload[0])
                    put_byte(b"QS", payload[1])
                elif fc == "I":
                    put_arr(b"IN", bytes(payload))
                elif fc == "S":
                    put_arr(b"SC", bytes(payload))
                elif fc in ("D", "N", "H", "P"):
                    put_int({"D": b"DL", "N": b"RS", "H": b"HC",
                             "P": b"PD"}[fc], payload)
            put_int(b"MQ", rec.mapq)
            if has_quals:
                for q in quals:
                    put_byte(b"QS", int(q))

        # content ids: stable order
        cid_map: Dict[bytes, int] = {}
        next_cid = 1
        all_keys = [k for k in _SERIES_INT + _SERIES_BYTE + _SERIES_ARR
                    if len(series[k]) > 0 or k in
                    (b"BF", b"CF", b"RL", b"AP", b"RG", b"TL", b"RN",
                     b"MF", b"NS", b"NP", b"TS", b"FN", b"MQ")]
        for k in all_keys:
            cid_map[k] = next_cid
            next_cid += 1
        tag_cids: Dict[bytes, int] = {}
        for tag3 in sorted(tag_series):
            tag_cids[tag3] = next_cid
            next_cid += 1

        # compression header
        pres = bytearray()
        entries = [(b"RN", bytes([1])), (b"AP", bytes([0])),
                   (b"RR", bytes([1])), (b"SM", b"\x1b" * 5)]
        td_blob = b"".join(ln + b"\x00" for ln in tag_lines)
        entries.append((b"TD", write_itf8(len(td_blob)) + td_blob))
        body = write_itf8(len(entries))
        for k, v in entries:
            body += k + v
        pres = write_itf8(len(body)) + body
        ds = bytearray()
        n_ds = 0
        dsbody = bytearray()
        for k in all_keys:
            if k in _SERIES_ARR:
                enc = enc_byte_array_len_ext(cid_map[k], cid_map[k])
            else:
                enc = enc_external(cid_map[k])
            dsbody += k + enc
            n_ds += 1
        dsb = write_itf8(n_ds) + dsbody
        ds = write_itf8(len(dsb)) + dsb
        te = bytearray()
        tebody = bytearray()
        for tag3, cid in tag_cids.items():
            key = (tag3[0] << 16) | (tag3[1] << 8) | tag3[2]
            tebody += write_itf8(key) + enc_byte_array_len_ext(cid, cid)
        teb = write_itf8(len(tag_cids)) + tebody
        te = write_itf8(len(teb)) + teb
        comp_blk = write_block(GZIP, CT_COMPRESSION_HEADER, 0,
                               bytes(pres + ds + te))

        # slice header + data blocks
        start = min(starts)
        span = max(ends) - start + 1
        ext_blocks = []
        content_ids = []
        for k in all_keys:
            ext_blocks.append(write_block(GZIP, CT_EXTERNAL, cid_map[k],
                                          bytes(series[k])))
            content_ids.append(cid_map[k])
        for tag3, cid in tag_cids.items():
            ext_blocks.append(write_block(GZIP, CT_EXTERNAL, cid,
                                          bytes(tag_series[tag3])))
            content_ids.append(cid)
        core_blk = write_block(RAW, CT_CORE, 0, b"")
        n_blocks = 1 + len(ext_blocks)
        md5 = hashlib.md5(ref[start - 1:start - 1 + span]).digest() \
            if ref else b"\x00" * 16
        sh = (write_itf8(ref_id) + write_itf8(start) + write_itf8(span)
              + write_itf8(len(recs)) + write_ltf8(self._counter)
              + write_itf8(n_blocks) + write_itf8_array(content_ids)
              + write_itf8(-1) + md5)
        slice_blk = write_block(GZIP, CT_SLICE_HEADER, 0, sh)
        blocks = comp_blk + slice_blk + core_blk + b"".join(ext_blocks)
        landmarks = [len(comp_blk)]
        off = self._write_container(blocks, ref_id, start, span, len(recs),
                                    n_bases, landmarks,
                                    n_blocks=2 + n_blocks)
        self._crai.append((ref_id, start, span, off, len(comp_blk),
                           len(blocks) - len(comp_blk)))
        self._counter += len(recs)

    def close(self):
        self._flush_slice()
        # EOF container (spec-defined constant semantics: empty container)
        eof_blk = write_block(RAW, CT_COMPRESSION_HEADER, 0, b"")
        hdr = (write_itf8(-1) + write_itf8(4542278) + write_itf8(0)
               + write_itf8(0) + write_ltf8(0) + write_ltf8(0)
               + write_itf8(1) + write_itf8_array([]))
        out = struct.pack("<i", len(eof_blk)) + hdr
        out += struct.pack("<I", zlib.crc32(out))
        self._fh.write(out + eof_blk)
        self._fh.close()
        with gzip.open(self.path + ".crai", "wt") as fh:
            for row in self._crai:
                fh.write("\t".join(map(str, row)) + "\n")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def bam_to_cram(bam_path: str, cram_path: str, reference: str):
    """Convert a BAM to CRAM (tests + migration tooling)."""
    from margin_tpu_torch.io.bam import BamReader
    with BamReader(bam_path) as br:
        with CramWriter(cram_path, br.header, reference) as cw:
            for rec in br:
                cw.write(rec)
