"""BCF 2.2 reader/writer.

Parity: the reference opens variant files through htslib's `bcf_open` /
`vcf_parse`, which accepts text VCF, VCF.gz and binary BCF transparently
(vcf.c uses the unified bcf_* API). This module decodes binary BCF records
back into VCF text lines so the whole variant subsystem (io/vcf.py parsing,
phased-VCF writer surgery) consumes one representation; the writer encodes
text VCF into BCF for tests and conversion.

Format (hts-specs VCFv4.x/BCFv2.2): BGZF container, "BCF\\2\\2" magic,
header text, then records of (l_shared, l_indiv) with typed values —
descriptor byte = length<<4 | type, length 15 -> following typed scalar
holds the true count; types: 1=int8, 2=int16, 3=int32, 5=float, 7=char.
FILTER/INFO/FORMAT ids use the header dictionary (implicit order, IDX=
overrides); GT is (allele+1)<<1 | phased.

Copy of `margin_tpu/io/bcf.py` with the port's imports.
"""

from __future__ import annotations

import re
import struct
from typing import List, Optional, Tuple

from margin_tpu_torch.io.bgzf import BgzfReader, BgzfWriter

_INT8_MISSING = -(1 << 7)
_INT16_MISSING = -(1 << 15)
_INT32_MISSING = -(1 << 31)
_INT8_EOV = _INT8_MISSING + 1
_INT16_EOV = _INT16_MISSING + 1
_INT32_EOV = _INT32_MISSING + 1
_FLOAT_MISSING = 0x7F800001
_FLOAT_EOV = 0x7F800002


def is_bcf(path: str) -> bool:
    try:
        with BgzfReader(path) as rd:
            return rd.read(5) == b"BCF\x02\x02"
    except Exception:
        return False


class _Cur:
    __slots__ = ("b", "i")

    def __init__(self, b: bytes):
        self.b = b
        self.i = 0

    def u8(self):
        v = self.b[self.i]
        self.i += 1
        return v

    def take(self, n):
        v = self.b[self.i:self.i + n]
        self.i += n
        return v


def _read_typed(cur: _Cur):
    """Returns (type, list-of-values) for one typed value."""
    desc = cur.u8()
    t = desc & 0xF
    n = desc >> 4
    if n == 15:
        _, nv = _read_typed(cur)
        n = int(nv[0])
    if t == 0:
        return t, []
    if t == 1:
        vals = list(struct.unpack(f"<{n}b", cur.take(n)))
    elif t == 2:
        vals = list(struct.unpack(f"<{n}h", cur.take(2 * n)))
    elif t == 3:
        vals = list(struct.unpack(f"<{n}i", cur.take(4 * n)))
    elif t == 5:
        vals = list(struct.unpack(f"<{n}f", cur.take(4 * n)))
    elif t == 7:
        return t, [cur.take(n).decode("utf-8", "replace")]
    else:
        raise ValueError(f"unsupported BCF type {t}")
    return t, vals


def _int_missing(t):
    return {1: _INT8_MISSING, 2: _INT16_MISSING, 3: _INT32_MISSING}[t]


def _int_eov(t):
    return {1: _INT8_EOV, 2: _INT16_EOV, 3: _INT32_EOV}[t]


def _fmt_float(v: float) -> str:
    s = f"{v:g}"
    return s


class BcfReader:
    """Iterates a BCF as VCF text lines (header lines, then records)."""

    def __init__(self, path: str):
        self._rd = BgzfReader(path)
        if self._rd.read(5) != b"BCF\x02\x02":
            raise ValueError(f"{path} is not a BCF2.2 file")
        l_text = struct.unpack("<I", self._rd.read(4))[0]
        text = self._rd.read(l_text).split(b"\x00")[0].decode("utf-8")
        self.header_text = text.rstrip("\n")
        # dictionaries: contigs by ##contig order; FILTER/INFO/FORMAT share
        # one string dictionary in declaration order, IDX= overriding.
        # PASS is id 0 unless declared.
        self.contigs: List[str] = []
        dict_entries: List[Tuple[int, str]] = []
        seen = set()
        auto_idx = 0
        has_pass = False
        for line in self.header_text.splitlines():
            m = re.match(r"##contig=<(.*)>", line)
            if m:
                im = re.search(r"ID=([^,>]+)", m.group(1))
                if im:
                    self.contigs.append(im.group(1))
                continue
            m = re.match(r"##(FILTER|INFO|FORMAT)=<(.*)>", line)
            if m:
                body = m.group(2)
                im = re.search(r"ID=([^,>]+)", body)
                xm = re.search(r"IDX=(\d+)", body)
                if im is None:
                    continue
                name = im.group(1)
                if name in seen:
                    continue
                seen.add(name)
                if name == "PASS":
                    has_pass = True
                if xm:
                    idx = int(xm.group(1))
                else:
                    if not has_pass and auto_idx == 0:
                        auto_idx = 1  # implicit PASS at 0
                    idx = auto_idx
                    auto_idx += 1
                dict_entries.append((idx, name))
        size = max([i for i, _ in dict_entries], default=-1) + 1
        self.dict_: List[Optional[str]] = [None] * max(size, 1)
        if not has_pass:
            self.dict_[0] = "PASS"
        for idx, name in dict_entries:
            if idx >= len(self.dict_):
                self.dict_ += [None] * (idx + 1 - len(self.dict_))
            self.dict_[idx] = name
        # INFO/FORMAT Type= for rendering (Flag vs valued)
        self.flag_keys = set()
        for line in self.header_text.splitlines():
            m = re.match(r"##INFO=<ID=([^,>]+).*Type=Flag", line)
            if m:
                self.flag_keys.add(m.group(1))

    def close(self):
        self._rd.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # -- record decoding -----------------------------------------------------

    def _render_vals(self, t, vals) -> str:
        if t == 7:
            return vals[0] if vals else "."
        out = []
        if t == 5:
            for v in vals:
                bits = struct.unpack("<I", struct.pack("<f", v))[0]
                if bits == _FLOAT_EOV:
                    break
                out.append("." if bits == _FLOAT_MISSING else _fmt_float(v))
        else:
            miss, eov = _int_missing(t), _int_eov(t)
            for v in vals:
                if v == eov:
                    break
                out.append("." if v == miss else str(v))
        return ",".join(out) if out else "."

    def records(self):
        """Yield VCF text data lines."""
        while True:
            head = self._rd.read(8)
            if len(head) < 8:
                return
            l_shared, l_indiv = struct.unpack("<II", head)
            shared = _Cur(self._rd.read(l_shared))
            indiv = _Cur(self._rd.read(l_indiv))
            (chrom_id, pos, _rlen) = struct.unpack("<iii", shared.take(12))
            (qual_bits,) = struct.unpack("<I", shared.take(4))
            n_info = struct.unpack("<H", shared.take(2))[0]
            n_allele = struct.unpack("<H", shared.take(2))[0]
            ns_fmt = struct.unpack("<I", shared.take(4))[0]
            n_sample = ns_fmt & 0xFFFFFF
            n_fmt = ns_fmt >> 24
            _, idv = _read_typed(shared)
            rid = idv[0] if idv and idv[0] else "."
            alleles = []
            for _ in range(n_allele):
                _, av = _read_typed(shared)
                alleles.append(av[0] if av else "")
            _, filt = _read_typed(shared)
            if filt:
                filter_s = ";".join(self.dict_[int(f)] or "?" for f in filt)
            else:
                filter_s = "."
            info_parts = []
            for _ in range(n_info):
                _, kv = _read_typed(shared)
                key = self.dict_[int(kv[0])] or "?"
                t, vals = _read_typed(shared)
                if t == 0 or key in self.flag_keys:
                    info_parts.append(key)
                else:
                    info_parts.append(f"{key}={self._render_vals(t, vals)}")
            info_s = ";".join(info_parts) if info_parts else "."
            qual_s = ("." if qual_bits == _FLOAT_MISSING else _fmt_float(
                struct.unpack("<f", struct.pack("<I", qual_bits))[0]))

            fmt_keys = []
            samples = [[] for _ in range(n_sample)]
            for _ in range(n_fmt):
                _, kv = _read_typed(indiv)
                key = self.dict_[int(kv[0])] or "?"
                fmt_keys.append(key)
                desc = indiv.u8()
                t = desc & 0xF
                per = desc >> 4
                if per == 15:
                    _, nv = _read_typed(indiv)
                    per = int(nv[0])
                for si in range(n_sample):
                    if t == 7:
                        s = indiv.take(per).decode("utf-8", "replace")
                        samples[si].append(s.rstrip("\x00") or ".")
                        continue
                    if t == 0:
                        samples[si].append(".")
                        continue
                    size = {1: 1, 2: 2, 3: 4, 5: 4}[t]
                    raw = indiv.take(size * per)
                    code = {1: "b", 2: "h", 3: "i", 5: "f"}[t]
                    vals = list(struct.unpack(f"<{per}{code}", raw))
                    if key == "GT" and t != 5:
                        miss, eov = _int_missing(t), _int_eov(t)
                        parts = []
                        phased = False
                        for j, v in enumerate(vals):
                            if v == eov:
                                break
                            if j > 0:
                                phased = bool(v & 1)
                            a = (v >> 1) - 1
                            if j > 0:
                                parts.append("|" if phased else "/")
                            parts.append("." if v == miss or a < 0
                                         else str(a))
                        samples[si].append("".join(parts) or ".")
                    else:
                        samples[si].append(self._render_vals(t, vals))
            cols = [self.contigs[chrom_id] if chrom_id < len(self.contigs)
                    else str(chrom_id),
                    str(pos + 1), str(rid), alleles[0] if alleles else ".",
                    ",".join(alleles[1:]) if len(alleles) > 1 else ".",
                    qual_s, filter_s, info_s]
            if fmt_keys:
                cols.append(":".join(fmt_keys))
                for s in samples:
                    cols.append(":".join(s))
            yield "\t".join(cols)

    def lines(self):
        """Header lines then data lines (the io/vcf.py text contract)."""
        for line in self.header_text.splitlines():
            yield line.rstrip("\n")
        yield from self.records()


# ---------------------------------------------------------------------------
# writer (tests + conversion)
# ---------------------------------------------------------------------------


def _typed_int(v: int) -> bytes:
    if -120 <= v <= 127:
        return bytes([0x11]) + struct.pack("<b", v)
    if -32000 <= v <= 32767:
        return bytes([0x12]) + struct.pack("<h", v)
    return bytes([0x13]) + struct.pack("<i", v)


def _typed_str(s: str) -> bytes:
    b = s.encode()
    if len(b) == 0:
        return bytes([0x07])
    if len(b) < 15:
        return bytes([(len(b) << 4) | 7]) + b
    return bytes([0xF7]) + _typed_int(len(b)) + b


def _typed_int_vec(vals) -> bytes:
    n = len(vals)
    if n == 0:
        return bytes([0x01])
    lo, hi = min(vals), max(vals)
    if -120 <= lo and hi <= 127:
        t, code, pack = 1, 0x1, "b"
    elif -32000 <= lo and hi <= 32767:
        t, code, pack = 2, 0x2, "h"
    else:
        t, code, pack = 3, 0x3, "i"
    if n < 15:
        head = bytes([(n << 4) | code])
    else:
        head = bytes([0xF0 | code]) + _typed_int(n)
    return head + struct.pack(f"<{n}{pack}", *vals)


def vcf_to_bcf(vcf_lines, out_path: str):
    """Encode text VCF lines as BCF 2.2 (tests + conversion tooling).
    Renders ID/REF/ALT/QUAL/FILTER(PASS/.)/GT + string-ish INFO and
    FORMAT values; INFO is carried as a single string key=value chain is
    NOT preserved — only Flag-less INFO is skipped. Intended for pipeline
    inputs where CHROM/POS/alleles/GT are what matters."""
    header_lines = []
    data = []
    for ln in vcf_lines:
        (header_lines if ln.startswith("#") else data).append(ln)
    header_text = "\n".join(header_lines) + "\n"
    contigs = []
    dict_names = ["PASS"]
    for ln in header_lines:
        m = re.match(r"##contig=<.*?ID=([^,>]+)", ln)
        if m:
            contigs.append(m.group(1))
        m = re.match(r"##(FILTER|INFO|FORMAT)=<ID=([^,>]+)", ln)
        if m and m.group(2) not in dict_names:
            dict_names.append(m.group(2))
    # contigs may be absent from the header: collect from data
    if not contigs:
        seen = []
        for ln in data:
            c = ln.split("\t", 1)[0]
            if c not in seen:
                seen.append(c)
        contigs = seen
        header_text = "".join(
            f"##contig=<ID={c}>\n" for c in contigs) + header_text
    if "GT" not in dict_names:
        dict_names.append("GT")
        header_text = ('##FORMAT=<ID=GT,Number=1,Type=String,'
                       'Description="Genotype">\n') + header_text
    cid = {c: i for i, c in enumerate(contigs)}
    did = {n: i for i, n in enumerate(dict_names)}

    w = BgzfWriter(out_path)
    hdr = header_text.encode() + b"\x00"
    w.write(b"BCF\x02\x02" + struct.pack("<I", len(hdr)) + hdr)
    for ln in data:
        cols = ln.split("\t")
        chrom, pos, rid, ref, alt = cols[0], cols[1], cols[2], cols[3], cols[4]
        qual, filt = cols[5], cols[6]
        alleles = [ref] + ([] if alt in (".", "") else alt.split(","))
        fmt_keys = cols[8].split(":") if len(cols) > 8 else []
        samples = cols[9:] if len(cols) > 9 else []
        shared = bytearray()
        shared += struct.pack("<iii", cid[chrom], int(pos) - 1, len(ref))
        if qual == ".":
            shared += struct.pack("<I", _FLOAT_MISSING)
        else:
            shared += struct.pack("<f", float(qual))
        shared += struct.pack("<H", 0)  # n_info
        shared += struct.pack("<H", len(alleles))
        shared += struct.pack("<I", (len(fmt_keys) << 24) | len(samples))
        shared += _typed_str("" if rid == "." else rid)
        for a in alleles:
            shared += _typed_str(a)
        shared += _typed_int_vec([0] if filt == "PASS" else [])
        indiv = bytearray()
        for fi, key in enumerate(fmt_keys):
            indiv += _typed_int(did.get(key, did["GT"]))
            vals_per_sample = []
            if key == "GT":
                for s in samples:
                    gt = s.split(":")[fi] if ":" in s or fi == 0 else "."
                    gt = s.split(":")[fi]
                    sep = "|" if "|" in gt else "/"
                    enc = []
                    for j, a in enumerate(gt.replace("|", "/").split("/")):
                        v = 0 if a == "." else ((int(a) + 1) << 1)
                        if j > 0 and sep == "|":
                            v |= 1
                        enc.append(v)
                    vals_per_sample.append(enc)
                per = max(len(v) for v in vals_per_sample)
                indiv += bytes([(per << 4) | 0x1])
                for v in vals_per_sample:
                    v = v + [_INT8_EOV] * (per - len(v))
                    indiv += struct.pack(f"<{per}b", *v)
            else:
                strs = [s.split(":")[fi] if fi < len(s.split(":")) else "."
                        for s in samples]
                per = max(max((len(x) for x in strs), default=1), 1)
                if per < 15:
                    indiv += bytes([(per << 4) | 0x7])
                else:
                    indiv += bytes([0xF7]) + _typed_int(per)
                for x in strs:
                    indiv += x.encode().ljust(per, b"\x00")
        w.write(struct.pack("<II", len(shared), len(indiv)))
        w.write(bytes(shared) + bytes(indiv))
    w.close()
