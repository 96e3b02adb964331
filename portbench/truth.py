"""The pipeline's outputs held to the generator's truth: the benchmark's
own readers of a haplotagged BAM, a phased VCF and a FASTA, and a banded
edit distance (a frozen copy of the port's `testing/synth.py`
`banded_edit_distance`). NumPy, zlib and the standard library only.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_TAG_SIZE = {b"A": 1, b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4,
             b"f": 4}
_INT_FMT = {b"c": "<b", b"C": "<B", b"s": "<h", b"S": "<H", b"i": "<i",
            b"I": "<I"}


def _tags(blob: bytes) -> Dict[bytes, object]:
    out, off = {}, 0
    while off + 3 <= len(blob):
        tag, typ = blob[off:off + 2], blob[off + 2:off + 3]
        off += 3
        if typ in _INT_FMT:
            out[tag] = struct.unpack_from(_INT_FMT[typ], blob, off)[0]
            off += _TAG_SIZE[typ]
        elif typ in _TAG_SIZE:
            off += _TAG_SIZE[typ]
        elif typ in (b"Z", b"H"):
            end = blob.index(b"\x00", off)
            out[tag] = blob[off:end]
            off = end + 1
        elif typ == b"B":
            sub = blob[off:off + 1]
            n = struct.unpack_from("<i", blob, off + 1)[0]
            off += 5 + n * _TAG_SIZE[sub]
        else:
            break
    return out


def bgzf_data(path: str) -> bytes:
    """The uncompressed contents of a BGZF file, block by block (each
    block's size from its BC field)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    out, off = [], 0
    while off + 18 <= len(raw):
        bsize = struct.unpack_from("<H", raw, off + 16)[0] + 1
        out.append(zlib.decompress(raw[off + 18:off + bsize - 8], -15))
        off += bsize
    return b"".join(out)


def bam_haplotags(path: str) -> List[Tuple[str, int]]:
    """(read name, HP tag or 0) of every record of a BAM."""
    data = bgzf_data(path)
    off = 4
    l_text = struct.unpack_from("<i", data, off)[0]
    off += 4 + l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        off += 8 + l_name
    out = []
    while off + 4 <= len(data):
        size = struct.unpack_from("<i", data, off)[0]
        rec = data[off + 4:off + 4 + size]
        off += 4 + size
        l_name, _, _, n_cig, _, l_seq = struct.unpack_from("<BBHHHi", rec, 8)
        name = rec[32:32 + l_name - 1].decode()
        tag_off = 32 + l_name + 4 * n_cig + (l_seq + 1) // 2 + l_seq
        out.append((name, int(_tags(rec[tag_off:]).get(b"HP", 0))))
    return out


def phased_sites(path: str) -> Dict[int, Tuple[str, str]]:
    """0-based position -> (GT, PS) of the first sample of a VCF."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            keys, vals = f[8].split(":"), f[9].split(":")
            rec = dict(zip(keys, vals))
            out[int(f[1]) - 1] = (rec.get("GT", "."), rec.get("PS", "."))
    return out


def fasta_seq(path: str) -> bytes:
    with open(path, "rb") as fh:
        return b"".join(line.strip() for line in fh
                        if not line.startswith(b">"))


def haplotag_error(tags: List[Tuple[str, int]], read_hap: Dict[str, int]):
    """(share of tagged reads whose tag disagrees with their haplotype of
    origin, under the better of the two labellings; tagged reads)."""
    agree = tagged = 0
    for name, hp in tags:
        if hp in (1, 2):
            tagged += 1
            agree += hp == read_hap[name]
    if not tagged:
        return 1.0, 0
    return min(agree, tagged - agree) / tagged, tagged


def phase_error(sites: Dict[int, Tuple[str, str]], variants, lo: int,
                hi: int):
    """(share of the phased het sites in [lo, hi) whose phase disagrees
    with the majority of their phase set, the share of the true het
    sites in [lo, hi) left unphased). A site is phased as 0|1 or 1|0;
    its phase agrees with the truth where ALT lies on the haplotype that
    carries it."""
    sets: Dict[str, List[int]] = {}
    truth = [v for v in variants if lo <= v.pos < hi]
    for v in truth:
        gt, ps = sites.get(v.pos, (".", "."))
        if gt not in ("0|1", "1|0"):
            continue
        alt_on = 2 if gt == "0|1" else 1
        sets.setdefault(ps, []).append(int(alt_on == v.hap))
    phased = sum(len(s) for s in sets.values())
    wrong = sum(min(sum(s), len(s) - sum(s)) for s in sets.values())
    return (wrong / phased if phased else 1.0,
            1.0 - phased / len(truth) if truth else 0.0)


def banded_edit_distance(a: bytes, b: bytes, band: int = 500) -> int:
    """Levenshtein distance of a and b over the alignments that stay within
    `band` columns of the line from (0, 0) to (len(a), len(b)): exact when
    the best alignment stays in it, an upper bound otherwise."""
    x = np.frombuffer(a, dtype=np.uint8)
    y = np.frombuffer(b, dtype=np.uint8)
    n, m = len(x), len(y)
    if n == 0 or m == 0:
        return n + m
    big = np.int64(1) << 40
    W = 2 * band + 1
    off = np.arange(-band, band + 1, dtype=np.int64)
    centre = (np.arange(n + 1, dtype=np.int64) * m) // n
    step = int(np.diff(centre).max(initial=0))
    fill = np.full(band + 2, 255, np.uint8)
    yp = np.concatenate([fill, y, fill])
    buf = np.full(W + step + 2, big)
    row0 = off.copy()
    row0[(off < 0) | (off > m)] = big
    buf[1:W + 1] = row0
    for i in range(1, n + 1):
        c = int(centre[i])
        s = c - int(centre[i - 1])
        up = buf[1 + s:1 + s + W]
        diag = buf[s:s + W]
        t = np.minimum(diag + (yp[c + 1:c + 1 + W] != x[i - 1]), up + 1)
        k0 = band - c
        if 0 <= k0 < W:
            t[k0] = i
        cur = np.minimum.accumulate(t - off) + off
        k_end = m - c + band
        if k_end < W - 1:
            cur[k_end + 1:] = big
        if k0 > 0:
            cur[:k0] = big
        buf[1:W + 1] = cur
    return int(buf[1 + m - int(centre[n]) + band])
