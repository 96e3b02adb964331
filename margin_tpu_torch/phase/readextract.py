"""Read-substring extraction at variant positions (the "ultra-fast" phase
input path).

Parity: extractReadSubstringsAtVariantPositions(2)
(htsIntegration.c:1722-1990) — for each read overlapping the chunk and each
variant window [refAlnStart, refAlnStopIncl) the read spans, cut out the
bases aligned within the window (insertions included) plus their quals.

Design difference: the reference walks the CIGAR base-by-base; here the
cigar is turned into op-level (ref_start, ref_end, seq_start) arrays and
each window boundary is resolved with a vectorized searchsorted — same
result, O(ops + variants log ops) per read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from margin_tpu_torch.io import bam as bamio
from margin_tpu_torch.io.vcf import VcfEntry
from margin_tpu_torch.params import Params
from margin_tpu_torch.phase.chunker import BamChunk, aligned_read_length, get_read_name


@dataclass
class ReadVcfSubstrings:
    """BamChunkRead + BamChunkReadVcfEntrySubstrings (margin.h:1096-1131)."""
    read_name: str
    forward_strand: bool
    full_read_length: int
    vcf_entries: List[VcfEntry] = field(default_factory=list)
    substrings: List[str] = field(default_factory=list)
    qualities: List[Optional[np.ndarray]] = field(default_factory=list)


def _op_tables(rec: bamio.BamRecord, chunk_overlap_start: int):
    """Build per-op tables over ref-consuming ops.

    Returns (ref_ends, seq_starts, is_match, ref_starts, total_query, softclip,
    r_begin, r_end) where positions are chunk-relative (0-based) counts of
    consumed reference bases."""
    ops = rec.cigar_ops()
    op = ops[:, 0]
    ln = ops[:, 1]
    consumes_ref = bamio._CONSUMES_REF[op]
    consumes_query = (op == bamio.CMATCH) | (op == bamio.CINS) | (op == bamio.CEQUAL) | (op == bamio.CDIFF)
    # cigarIdxInSeq counts M/I/=/X only (soft clips are excluded and re-added
    # via the start-softclip offset; htsIntegration.c:1912-1931)
    seq_cum = np.concatenate(([0], np.cumsum(np.where(consumes_query & (op != bamio.CSOFT_CLIP), ln, 0))))
    ref_cum = np.concatenate(([0], np.cumsum(np.where(consumes_ref, ln, 0)))) + (rec.pos - chunk_overlap_start)
    keep = consumes_ref
    ref_starts = ref_cum[:-1][keep]
    ref_ends = ref_cum[1:][keep]
    seq_starts = seq_cum[:-1][keep]
    is_match = (op[keep] == bamio.CMATCH) | (op[keep] == bamio.CEQUAL) | (op[keep] == bamio.CDIFF)
    total_query = int(seq_cum[-1])
    return ref_starts, ref_ends, seq_starts, is_match, total_query


def _seq_index_at(t, r_begin, ref_starts, ref_ends, seq_starts, is_match, total_query):
    """Read index (cigarIdxInSeq) at the earliest moment the walk has
    consumed >= t reference bases. t may be an array."""
    t = np.asarray(t, dtype=np.int64)
    out = np.zeros_like(t)
    past = t > r_begin
    if np.any(past):
        idx = np.searchsorted(ref_ends, t[past], side="left")
        idx = np.minimum(idx, len(ref_ends) - 1)
        base = seq_starts[idx]
        within = np.where(is_match[idx], t[past] - ref_starts[idx], 0)
        within = np.maximum(within, 0)
        out[past] = base + within
    # t beyond the end of the alignment: everything consumed
    beyond = t > (ref_ends[-1] if len(ref_ends) else r_begin)
    out[beyond] = total_query
    return out


class PrefetchedChunkReader:
    """One BAM region scan shared by every extraction pass of a chunk.

    The driver extracts substrings for primary variants, filtered variants,
    and (with SV handling) small/SV splits — four scans of the same region
    (htsIntegration.c re-streams per call too, but its htslib iterator hits
    the OS page cache; here each scan re-inflates BGZF blocks). Fetching the
    records once removes ~75% of the readextract wall time."""

    def __init__(self, reader: bamio.BamReader, bam_chunk: BamChunk):
        self.base_reader = reader
        self._bam_chunk = bam_chunk
        self._records = None  # lazy: the native extraction path never
        # parses Python records at all
        # per-record derived data shared across passes
        self.op_cache: dict = {}
        self.seq_cache: dict = {}
        self.alen_cache: dict = {}

    @property
    def records(self):
        if self._records is None:
            ck = self._bam_chunk
            self._records = list(self.base_reader.fetch(
                ck.ref_name, max(ck.chunk_overlap_start - 1, 0),
                ck.chunk_overlap_end))
        return self._records

    def fetch(self, contig: str, start: int, end: int):
        return iter(self.records)


def _extract_native(bam_chunk: BamChunk, vcf_entries, reader, params,
                    keep_filtered: bool):
    """Native single-call extraction (marginio mio_extract_substrings):
    the whole fetch+filter+CIGAR-walk+substring-cut runs in C; Python only
    assembles ReadVcfSubstrings objects. Returns None when the native
    engine is unavailable (the vectorized Python walk below is the
    fallback and the parity oracle)."""
    base = getattr(reader, "base_reader", reader)
    if not isinstance(base, bamio.BamReader):
        return None
    try:
        nb = base._native_bam()
    except Exception:
        return None
    if nb is None or not hasattr(nb, "extract_substrings"):
        return None
    tid = base.header.ref_id(bam_chunk.ref_name)
    if tid < 0:
        return None
    pp = params.polish
    positions = np.array([e.ref_pos for e in vcf_entries], dtype=np.int64)
    win_starts = np.array([e.ref_aln_start for e in vcf_entries],
                          dtype=np.int64)
    win_ends = np.array([e.ref_aln_stop_incl for e in vcf_entries],
                        dtype=np.int64)
    res = nb.extract_substrings(
        tid, max(bam_chunk.chunk_overlap_start - 1, 0),
        bam_chunk.chunk_overlap_end, bam_chunk.chunk_overlap_start,
        bam_chunk.chunk_start, bam_chunk.chunk_end,
        positions, win_starts, win_ends,
        pp.filterAlignmentsWithMapQBelowThisThreshold,
        pp.includeSecondaryAlignments, pp.includeSupplementaryAlignments,
        keep_filtered)
    if res is None:
        return None
    reads: List[ReadVcfSubstrings] = []
    filtered_reads: List[ReadVcfSubstrings] = []
    names = res["names"].split(b"\0")
    rflags = res["rflags"].tolist()
    rlen = res["rlen"].tolist()
    bcrs = []
    has_q = []
    for i in range(res["n_reads"]):
        fl = rflags[i]
        bcr = ReadVcfSubstrings(names[i].decode("ascii", "replace"),
                                bool(fl & 1), rlen[i])
        bcrs.append(bcr)
        has_q.append(bool(fl & 4))
        (filtered_reads if fl & 2 else reads).append(bcr)
    subs = res["subs"]
    quals = res["quals"]
    pr = res["pair_read"].tolist()
    pv = res["pair_var"].tolist()
    so = res["sub_off"].tolist()
    sl = res["sub_len"].tolist()
    for j in range(res["n_pairs"]):
        ridx = pr[j]
        a = so[j]
        b = a + sl[j]
        bcr = bcrs[ridx]
        bcr.vcf_entries.append(vcf_entries[pv[j]])
        bcr.substrings.append(subs[a:b].decode("ascii"))
        bcr.qualities.append(quals[a:b] if has_q[ridx] else None)
    return reads, filtered_reads


def extract_read_substrings(bam_chunk: BamChunk, vcf_entries: List[VcfEntry],
                            reader: bamio.BamReader, params: Params,
                            keep_filtered: bool = True):
    """extractReadSubstringsAtVariantPositions2 (htsIntegration.c:1762-1990).

    Returns (reads, filtered_reads): ReadVcfSubstrings lists. Variant
    windows must be 0-based (ref_aln_start/stop_incl relative to
    chunkOverlapStart)."""
    pp = params.polish
    reads: List[ReadVcfSubstrings] = []
    filtered_reads: List[ReadVcfSubstrings] = []
    if not vcf_entries:
        return reads, filtered_reads
    if os.environ.get("MARGIN_TPU_NATIVE_EXTRACT", "1") != "0":
        out = _extract_native(bam_chunk, vcf_entries, reader, params,
                              keep_filtered)
        if out is not None:
            return out
    op_cache = getattr(reader, "op_cache", None)
    seq_cache = getattr(reader, "seq_cache", None)
    alen_cache = getattr(reader, "alen_cache", None)

    positions = np.array([e.ref_pos for e in vcf_entries], dtype=np.int64)  # 1-based POA
    win_starts = np.array([e.ref_aln_start for e in vcf_entries], dtype=np.int64)
    win_ends = np.array([e.ref_aln_stop_incl for e in vcf_entries], dtype=np.int64)

    # the reference's region string is 1-based inclusive -> scan [start-1, end)
    for rec in reader.fetch(bam_chunk.ref_name,
                            max(bam_chunk.chunk_overlap_start - 1, 0),
                            bam_chunk.chunk_overlap_end):
        if rec.l_seq <= 0 or len(rec.cigar) == 0 or rec.is_unmapped:
            continue
        if not pp.includeSecondaryAlignments and rec.is_secondary:
            continue
        if not pp.includeSupplementaryAlignments and rec.is_supplementary:
            continue
        is_filtered = False
        if rec.mapq < pp.filterAlignmentsWithMapQBelowThisThreshold:
            if not keep_filtered:
                continue
            is_filtered = True

        if alen_cache is not None:
            alen = alen_cache.get(id(rec))
            if alen is None:
                alen = alen_cache[id(rec)] = aligned_read_length(rec)
            aln_len, start_sc, _ = alen
        else:
            aln_len, start_sc, _ = aligned_read_length(rec)
        if aln_len <= 0:
            continue
        aln_start = rec.pos
        aln_end = aln_start + aln_len
        # chunk inclusion uses the *nominal* chunk bounds (htsIntegration.c:1841-1842)
        if aln_start >= bam_chunk.chunk_end or aln_end <= bam_chunk.chunk_start:
            continue

        r_begin = aln_start - bam_chunk.chunk_overlap_start
        r_end = aln_end - bam_chunk.chunk_overlap_start

        # candidate variants: pos0 >= r_begin (binary search on 1-based refPos
        # with key r_begin+1; htsIntegration.c:1852-1855) and window started
        # before read end
        lo = np.searchsorted(positions, r_begin + 1, side="left")
        if lo >= len(positions):
            continue
        hi = lo + int(np.searchsorted(win_starts[lo:], r_end, side="right"))
        if hi <= lo:
            # window of first candidate hasn't started before read end
            bcr = ReadVcfSubstrings(get_read_name(rec, bam_chunk.ref_name),
                                    not rec.is_reverse, aln_len)
            (filtered_reads if is_filtered else reads).append(bcr)
            continue

        if op_cache is not None:
            tables = op_cache.get(id(rec))
            if tables is None:
                tables = op_cache[id(rec)] = _op_tables(
                    rec, bam_chunk.chunk_overlap_start)
        else:
            tables = _op_tables(rec, bam_chunk.chunk_overlap_start)
        ref_starts, ref_ends, seq_starts, is_match, total_query = tables

        sel = np.arange(lo, hi)
        t_start = win_starts[sel]
        t_end = win_ends[sel]
        seq_s = _seq_index_at(t_start, r_begin, ref_starts, ref_ends,
                              seq_starts, is_match, total_query)
        seq_e = _seq_index_at(t_end, r_begin, ref_starts, ref_ends,
                              seq_starts, is_match, total_query)
        ends_in_read = t_end <= r_end
        # end-of-read keep condition: relpos_final >= refPos(1-based)
        # (htsIntegration.c:1626-1631)
        keep_eor = r_end >= positions[sel]
        keep = (seq_e > seq_s) & (ends_in_read | keep_eor)

        bcr = ReadVcfSubstrings(get_read_name(rec, bam_chunk.ref_name),
                                not rec.is_reverse, aln_len)
        if np.any(keep):
            if seq_cache is not None:
                cached = seq_cache.get(id(rec))
                if cached is None:
                    cached = seq_cache[id(rec)] = (rec.seq(), rec.quals())
                seq, quals = cached
            else:
                seq, quals = rec.seq(), rec.quals()
            for k in np.flatnonzero(keep):
                a = int(seq_s[k]) + start_sc
                b = int(seq_e[k]) + start_sc
                bcr.vcf_entries.append(vcf_entries[lo + k])
                bcr.substrings.append(seq[a:b])
                bcr.qualities.append(None if quals is None else quals[a:b])
        (filtered_reads if is_filtered else reads).append(bcr)

    return reads, filtered_reads


def extract_read_substrings_sv_aware(bam_chunk, vcf_entries, reader, params,
                                     keep_filtered=True):
    """extractReadSubstringsAtVariantPositions (htsIntegration.c:1722-1759):
    splits SV and small variants into separate passes, then merges per-read."""
    if params.phase.indelSizeForSVHandling > 0:
        small = [e for e in vcf_entries if not e.is_sv]
        sv = [e for e in vcf_entries if e.is_sv]
        r_small, f_small = extract_read_substrings(bam_chunk, small, reader, params, keep_filtered)
        r_sv, f_sv = extract_read_substrings(bam_chunk, sv, reader, params, keep_filtered)
        return (_merge_read_lists(r_sv, r_small), _merge_read_lists(f_sv, f_small))
    return extract_read_substrings(bam_chunk, vcf_entries, reader, params, keep_filtered)


def _merge_read_lists(l1, l2):
    """mergeVariantTypeSeparatedReadLists (htsIntegration.c:1675-1719)."""
    by_name = {}
    out = []
    for r in l1:
        by_name[r.read_name] = r
        out.append(r)
    for r in l2:
        prev = by_name.get(r.read_name)
        if prev is None:
            by_name[r.read_name] = r
            out.append(r)
        else:
            prev.vcf_entries.extend(r.vcf_entries)
            prev.substrings.extend(r.substrings)
            prev.qualities.extend(r.qualities)
    return out
