"""Maximal-expected-accuracy alignment selection, left-shift normalization,
and read-to-consensus alignments.

Copy of `margin_tpu/polish/alignment.py` with the port's imports. Parity: getMaximalExpectedAccuracyPairwiseAlignment
(pairwiseAligner.c:1325-1430), leftShiftAlignment (:1432-1471),
poa_getReadAlignmentsToConsensus (poa.c:1621-1672).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from margin_tpu_torch.params import Params
from margin_tpu_torch.polish.poa import (Poa, PoaRead,
                                   get_aligned_pairs_cropping_reference)


def _cumulative_gap_probs(gap_pairs: np.ndarray, seq_len: int,
                          x_not_y: bool) -> np.ndarray:
    """getCumulativeGapProbs (pairwiseAligner.c:1300-1317)."""
    cum = np.zeros(seq_len, dtype=np.int64)
    col = 1 if x_not_y else 2
    for row in gap_pairs:
        cum[row[col]] += row[0]
    return np.cumsum(cum)


def _indel_prob(cum: np.ndarray, start: int, length: int) -> int:
    if length == 0:
        return 0
    return int(cum[start + length - 1] - (cum[start - 1] if start > 0 else 0))


def mea_alignment(aligned_pairs: np.ndarray, gap_x_pairs: np.ndarray,
                  gap_y_pairs: np.ndarray, lx: int, ly: int,
                  gap_gamma: float) -> Tuple[np.ndarray, float]:
    """getMaximalExpectedAccuracyPairwiseAlignment
    (pairwiseAligner.c:1325-1430): pick a maximum-expected-accuracy ordered
    subset of aligned pairs. Returns ((N,3) pairs, score)."""
    pairs = sorted(map(tuple, aligned_pairs), key=lambda t: (t[1], t[2]))
    n = len(pairs)
    gx_cum = _cumulative_gap_probs(gap_x_pairs, lx, True) if lx else np.zeros(0, np.int64)
    gy_cum = _cumulative_gap_probs(gap_y_pairs, ly, False) if ly else np.zeros(0, np.int64)
    scores = np.zeros(n + 1)
    backptr = np.full(n + 1, -1, dtype=np.int64)
    high = np.zeros(n + 1, dtype=bool)
    max_score = 0.0
    for i in range(n + 1):
        if i == n:
            match_prob, x, y = 0, lx, ly
        else:
            match_prob, x, y = pairs[i]
        score = match_prob + (_indel_prob(gx_cum, 0, x)
                              + _indel_prob(gy_cum, 0, y)) * gap_gamma
        bp = -1
        for j in range(i - 1, -1, -1):
            _, x2, y2 = pairs[j]
            if x2 < x and y2 < y:
                s = match_prob + scores[j] + \
                    (_indel_prob(gx_cum, x2 + 1, x - x2 - 1)
                     + _indel_prob(gy_cum, y2 + 1, y - y2 - 1)) * gap_gamma
                if s > score:
                    score = s
                    bp = j
                if high[j]:
                    break
        backptr[i] = bp
        scores[i] = score
        s = score + ((_indel_prob(gx_cum, x + 1, lx - x - 1) if x < lx else 0)
                     + (_indel_prob(gy_cum, y + 1, ly - y - 1) if y < ly else 0)) * gap_gamma
        if s >= max_score:
            max_score = s
            high[i] = True
    out = []
    i = backptr[n]
    while i >= 0:
        out.append(pairs[i])
        i = backptr[i]
    out.reverse()
    return np.array(out, dtype=np.int64).reshape(-1, 3), max_score


def left_shift_alignment(alignment: np.ndarray, x_sym: np.ndarray,
                         y_sym: np.ndarray) -> np.ndarray:
    """leftShiftAlignment (pairwiseAligner.c:1432-1471)."""
    out = []
    x, y = len(x_sym), len(y_sym)
    pairs = list(map(tuple, alignment))
    for w, x2, y2 in reversed(pairs):
        while (x - x2 > 1 or y - y2 > 1) and x > 0 and y > 0 and \
                x_sym[x - 1] == y_sym[y - 1]:
            out.append((w, x - 1, y - 1))
            x -= 1
            y -= 1
            if x2 == x or y2 == y:
                break
        if x2 < x and y2 < y:
            out.append((w, x2, y2))
            x, y = x2, y2
    while x > 0 and y > 0 and x_sym[x - 1] == y_sym[y - 1]:
        w = pairs[0][0] if pairs else 1
        out.append((w, x - 1, y - 1))
        x -= 1
        y -= 1
    out.reverse()
    return np.array(out, dtype=np.int64).reshape(-1, 3)


def poa_get_read_alignments_to_consensus(poa: Poa, reads: List[PoaRead],
                                         params: Params, tables,
                                         use_lut: bool = False) -> List[np.ndarray]:
    """poa_getReadAlignmentsToConsensus (poa.c:1621-1672): left-shifted MEA
    alignments of each read against the POA reference."""
    pp = params.polish
    anchor_alignments = poa.get_anchor_alignments(None, len(reads), pp)
    ref_sym = poa.ref_string.symbols()
    out = []
    for i, read in enumerate(reads):
        matches, inserts, deletes = get_aligned_pairs_cropping_reference(
            poa.ref_string, read, anchor_alignments[i], pp, tables, use_lut)
        aln, _score = mea_alignment(matches, deletes, inserts,
                                    poa.ref_string.length,
                                    read.rle_read.length, pp.p.gapGamma)
        out.append(left_shift_alignment(aln, ref_sym, read.rle_read.symbols()))
    return out


class MsaView:
    """msaView (impl/view.c): per-reference-position aligned read
    coordinates + preceding-insert bookkeeping, from pairwise alignments."""

    def __init__(self, ref_sym: np.ndarray, read_syms: List[np.ndarray],
                 alignments: List[np.ndarray]):
        self.ref_sym = ref_sym
        self.read_syms = read_syms
        n_reads = len(read_syms)
        n_ref = len(ref_sym)
        # aligned read coordinate per (ref pos, read), -1 if none
        self.aligned = np.full((n_ref, n_reads), -1, dtype=np.int64)
        # inserts preceding each ref position: (read, read_start, length)
        self.inserts: List[List[Tuple[int, int, int]]] = [[] for _ in range(n_ref + 1)]
        for r, aln in enumerate(alignments):
            prev_x, prev_y = -1, -1
            for _w, x, y in aln:
                if y - prev_y > 1:
                    self.inserts[x].append((r, prev_y + 1, y - prev_y - 1))
                self.aligned[x, r] = y
                prev_x, prev_y = x, y
            # trailing read bases after the last aligned pair are an insert
            # preceding the next reference position (viewTest.c:66-81)
            if prev_x >= 0 and len(read_syms[r]) - 1 > prev_y:
                self.inserts[prev_x + 1].append(
                    (r, prev_y + 1, len(read_syms[r]) - 1 - prev_y))

    def coverage(self, ref_pos: int) -> int:
        return int((self.aligned[ref_pos] >= 0).sum())

    def seq_coordinate(self, ref_pos: int, read: int) -> int:
        """msaView_getSeqCoordinate: aligned read coordinate or -1."""
        return int(self.aligned[ref_pos, read])

    def preceding_insert_length(self, ref_pos: int, read: int) -> int:
        """msaView_getPrecedingInsertLength."""
        for r, _s, ln in self.inserts[ref_pos]:
            if r == read:
                return ln
        return 0

    def preceding_insert_start(self, ref_pos: int, read: int) -> int:
        """msaView_getPrecedingInsertStart: read coordinate or -1."""
        for r, s, _ln in self.inserts[ref_pos]:
            if r == read:
                return s
        return -1

    def max_precursor_insert_length(self, ref_pos: int) -> int:
        return max((ln for _, _, ln in self.inserts[ref_pos]), default=0)
