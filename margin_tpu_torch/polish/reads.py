"""Read + anchor-alignment extraction for the polish path.

Copy of `margin_tpu/polish/reads.py` with the port's imports.

Parity: convertToReadsAndAlignmentsWithFiltered (htsIntegration.c:557-891):
per chunk, crop each read to the chunk window, build (ref, read, expansion)
anchor tuples from the CIGAR matches, optionally include softclips at chunk
borders, optionally RLE the read and re-encode the alignment.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from margin_tpu_torch.io import bam as bamio
from margin_tpu_torch.params import PolishParams
from margin_tpu_torch.phase.chunker import BamChunk, aligned_read_length, get_read_name
from margin_tpu_torch.polish.poa import PoaRead
from margin_tpu_torch.rle import RleString, run_length_encode_alignment


def convert_to_reads_and_alignments(bam_chunk: BamChunk,
                                    reference: Optional[RleString],
                                    reader: bamio.BamReader,
                                    params: PolishParams,
                                    keep_filtered: bool = True):
    """Returns (reads, alignments, filtered_reads, filtered_alignments).
    Alignments are (N, 3) int arrays of (refPos_rel, readPos, expansion) —
    RLE-space when params.useRunLengthEncoding."""
    chunk_start = bam_chunk.chunk_overlap_start
    chunk_end = bam_chunk.chunk_overlap_end
    include_softclip = params.includeSoftClipping
    ref_map = reference.non_rle_to_rle_map() if reference is not None else None

    reads: List[PoaRead] = []
    alignments: List[np.ndarray] = []
    f_reads: List[PoaRead] = []
    f_alignments: List[np.ndarray] = []

    for rec in reader.fetch(bam_chunk.ref_name, max(chunk_start - 1, 0), chunk_end):
        if rec.l_seq <= 0 or len(rec.cigar) == 0 or rec.is_unmapped:
            continue
        if not params.includeSecondaryAlignments and rec.is_secondary:
            continue
        if not params.includeSupplementaryAlignments and rec.is_supplementary:
            continue
        filtered = False
        if rec.mapq < params.filterAlignmentsWithMapQBelowThisThreshold:
            if not keep_filtered:
                continue
            filtered = True

        aln_len, start_sc, end_sc = aligned_read_length(rec)
        if aln_len <= 0:
            continue
        aln_start = rec.pos
        aln_end = aln_start + aln_len
        if aln_start >= chunk_end or aln_end <= chunk_start:
            continue

        ops = rec.cigar_ops()
        # fully vectorized cigar walk (the per-op loop's 100k+ tiny numpy
        # calls per 100 kb chunk dominated this stage): per-op cumulative
        # ref/seq positions, then ALL match pairs emitted with one
        # repeat+arange, preserving the scalar walk's semantics exactly
        op_a = ops[:, 0]
        ln_a = ops[:, 1]
        is_m = ((op_a == bamio.CMATCH) | (op_a == bamio.CEQUAL)
                | (op_a == bamio.CDIFF))
        is_ref = is_m | (op_a == bamio.CDEL) | (op_a == bamio.CREF_SKIP)
        is_seq = is_m | (op_a == bamio.CINS)
        ref_pos = aln_start + np.concatenate(
            ([0], np.cumsum(np.where(is_ref, ln_a, 0))))[:-1]
        seq_pos = np.concatenate(
            ([0], np.cumsum(np.where(is_seq, ln_a, 0))))[:-1]
        cigar_idx_seq = int(seq_pos[-1] + (ln_a[-1] if is_seq[-1] else 0)) \
            if len(ops) else 0

        m_idx = np.flatnonzero(is_m)
        m_ref = ref_pos[m_idx]
        m_seq = seq_pos[m_idx]
        m_ln = ln_a[m_idx]
        # clip each M run to [chunk_start, chunk_end)
        lo = np.maximum(m_ref, chunk_start)
        hi = np.minimum(m_ref + m_ln, chunk_end)
        keep_ln = np.maximum(hi - lo, 0)
        total = int(keep_ln.sum())
        if total:
            base = np.repeat(np.arange(len(m_idx)), keep_ln)
            within = np.arange(total) - np.repeat(
                np.concatenate(([0], np.cumsum(keep_ln)[:-1])), keep_ln)
            refs_all = lo[base] + within
            seqs_all = (m_seq + (lo - m_ref))[base] + within
            aln_pairs = np.stack([refs_all, seqs_all], axis=1)
        else:
            aln_pairs = np.zeros((0, 2), dtype=np.int64)
        aligned_read_len = total
        # insertions inside the window add to the aligned length
        i_idx = np.flatnonzero(op_a == bamio.CINS)
        if len(i_idx):
            i_in = (ref_pos[i_idx] >= chunk_start) & (ref_pos[i_idx]
                                                      < chunk_end)
            aligned_read_len += int(ln_a[i_idx][i_in].sum())
        # first_aligned_idx: the first ref-consuming op whose END reaches
        # chunk_start sets it (M: seq index at the clip point; D/N: seq
        # index at the op)
        first_aligned_idx = -1 if aln_start < chunk_start else 0
        if first_aligned_idx < 0:
            r_idx = np.flatnonzero(is_ref)
            r_end = ref_pos[r_idx] + ln_a[r_idx]
            trig = np.flatnonzero(r_end >= chunk_start)
            if len(trig):
                j = r_idx[trig[0]]
                if is_m[j]:
                    first_aligned_idx = int(
                        seq_pos[j] + max(chunk_start - ref_pos[j], 0))
                else:
                    first_aligned_idx = int(seq_pos[j])
        if first_aligned_idx < 0:
            first_aligned_idx = cigar_idx_seq

        # seqCigarModification / readStartIdxInChunk (htsIntegration.c:677-802)
        seq_len = aligned_read_len
        if include_softclip:
            if aln_start < chunk_start:
                read_start_idx = first_aligned_idx + start_sc
                seq_mod = -first_aligned_idx
            elif aln_start - start_sc <= chunk_start:
                included = aln_start - chunk_start
                read_start_idx = start_sc - included
                seq_mod = included
                seq_len += included
            else:
                read_start_idx = 0
                seq_mod = start_sc
                seq_len += start_sc
        else:
            read_start_idx = first_aligned_idx + start_sc if aln_start < chunk_start \
                else start_sc
            seq_mod = -first_aligned_idx if aln_start < chunk_start else 0

        read_end_idx = read_start_idx + seq_len
        if aln_end < chunk_end and include_softclip:
            if aln_end + end_sc <= chunk_end:
                read_end_idx += end_sc
                seq_len += end_sc
            else:
                included = chunk_end - aln_end
                seq_len += included
                read_end_idx += included

        if len(aln_pairs) == 0 or seq_len == 0:
            continue
        # to chunk-relative ref coords and extracted-seq read coords
        aln_arr = np.zeros((len(aln_pairs), 3), dtype=np.int64)
        aln_arr[:, 0] = aln_pairs[:, 0] - chunk_start
        aln_arr[:, 1] = aln_pairs[:, 1] + (start_sc - read_start_idx)
        aln_arr[:, 2] = params.p.diagonalExpansion

        seq = rec.seq()[read_start_idx:read_end_idx]
        quals = rec.quals()
        q = None if quals is None else quals[read_start_idx:read_end_idx]

        name = get_read_name(rec, bam_chunk.ref_name)
        if params.useRunLengthEncoding:
            rle = RleString.encode(seq)
            rle_q = None if q is None else rle.rle_qualities(q)
            read = PoaRead(name, not rec.is_reverse, rle, rle_q, len(rec.raw))
            if ref_map is not None:
                read_map = rle.non_rle_to_rle_map()
                aln_arr = run_length_encode_alignment(aln_arr, ref_map, read_map)
        else:
            rle = RleString.identity(seq)
            read = PoaRead(name, not rec.is_reverse, rle, q, len(rec.raw))
        (f_reads if filtered else reads).append(read)
        (f_alignments if filtered else alignments).append(aln_arr)

    return reads, alignments, f_reads, f_alignments
