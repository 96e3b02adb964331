"""Sequence-overlap stitching for polished chunks.

Parity: removeOverlap (stitching.c:425-542) + chunkToStitch_trimAdjacentChunks2
(stitching.c:559-660): align the RLE suffix/prefix of the 2x chunkBoundary
overlap with k-mer anchors + the banded aligner (default nucleotide state
machine, ragged ends), cut at the max-weight aligned pair.

Counterpart of `margin_tpu/polish/stitcher.py`. The overlap alignment is
`banded.banded_posteriors` with the exact logAdd, as in the JAX package;
it runs on the given device (K2 for overlaps of 2 x chunkBoundary).
"""

from __future__ import annotations

from typing import List, Tuple

from margin_tpu_torch import _ext
from margin_tpu_torch.alphabet import seq_to_symbols
from margin_tpu_torch.ops import banded, pairhmm
from margin_tpu_torch.params import Params, StateMachineParams
from margin_tpu_torch.polish.kmers import get_kmer_alignment_anchors
from margin_tpu_torch.rle import RleString

MIN_OVERLAP_ANCHOR_PAIRS = 2  # stitching.c:632
PAIRWISE_ALIGNER_KMER_SIZE = None  # None -> kmers.KMER_SIZE (20)


def set_min_overlap_anchor_pairs(n: int) -> None:
    """setMinOverlapAnchorPairs (stitching.c test hook)."""
    global MIN_OVERLAP_ANCHOR_PAIRS
    MIN_OVERLAP_ANCHOR_PAIRS = n


def set_pairwise_aligner_kmer_size(k) -> None:
    """setPairwiseAlignerKmerSize (pairwiseAligner.c test hook)."""
    global PAIRWISE_ALIGNER_KMER_SIZE
    PAIRWISE_ALIGNER_KMER_SIZE = k


_DEFAULT_TABLES: dict = {}


def _default_tables(device):
    dev = _ext.resolve_device(device)
    if dev not in _DEFAULT_TABLES:
        sm = StateMachineParams.default_nucleotide()
        _DEFAULT_TABLES[dev] = pairhmm.PairHmmTables.from_params(
            sm, device=dev)
    return _DEFAULT_TABLES[dev]


def remove_overlap(prefix: str, suffix: str, approx_overlap: int,
                   params: Params, device="cuda") -> Tuple[int, int, int]:
    """removeOverlap (stitching.c:425-542) on RLE-space strings.
    Returns (overlap_weight, prefix_crop_end_excl, suffix_crop_start)."""
    plen, slen = len(prefix), len(suffix)
    i = max(plen - approx_overlap, 0)
    j = min(approx_overlap, slen)

    p_ns = plen > 0 and prefix[i] == "N" and prefix[-1] == "N"
    s_ns = slen > 0 and suffix[0] == "N" and suffix[j - 1] == "N"
    if p_ns and s_ns:
        return -1, plen, 0

    x_sym = seq_to_symbols(prefix[i:])
    y_sym = seq_to_symbols(suffix[:j])
    kmer_kwargs = {}
    if PAIRWISE_ALIGNER_KMER_SIZE is not None:
        kmer_kwargs["kmer_size"] = PAIRWISE_ALIGNER_KMER_SIZE
    anchors = get_kmer_alignment_anchors(x_sym, y_sym,
                                         params.polish.p.diagonalExpansion,
                                         **kmer_kwargs)
    if len(anchors) < MIN_OVERLAP_ANCHOR_PAIRS:
        return -1, plen, 0

    (matches, _gx, _gy), _total = banded.banded_posteriors(
        _default_tables(device), x_sym, y_sym, anchors,
        params.polish.p.diagonalExpansion, strand=0,
        ragged_left=True, ragged_right=True,
        threshold=params.polish.p.threshold,
        dynamic=params.polish.p.dynamicAnchorExpansion)

    best = None
    for w, p, s in matches:
        if p < 0 or s < 0 or p >= plen - i or s >= j:
            continue
        if best is None or w > best[0]:
            best = (int(w), int(p), int(s))
    if best is None:
        return -1, plen, 0
    return best[0], best[1] + i, best[2]


def trim_adjacent_sequences(p_seq: str, seq: str, params: Params,
                            device="cuda") -> Tuple[str, str, int]:
    """chunkToStitch_trimAdjacentChunks2 (stitching.c:559-660) on expanded
    sequences. Returns (trimmed_prev, trimmed_cur, overlap_weight)."""
    use_rle = params.polish.useRunLengthEncoding
    p_rle = RleString.encode(p_seq) if use_rle else RleString.identity(p_seq)
    s_rle = RleString.encode(seq) if use_rle else RleString.identity(seq)
    weight, p_crop_end, s_crop_start = remove_overlap(
        p_rle.bases, s_rle.bases, params.polish.chunkBoundary * 2, params,
        device)
    p_trim = p_rle.substring(0, p_crop_end)
    s_trim = s_rle.substring(s_crop_start, s_rle.length - s_crop_start)
    return p_trim.expand(), s_trim.expand(), weight


def stitch_sequences(chunks: List[Tuple[str, int, str]], params: Params,
                     device="cuda") -> List[Tuple[str, str]]:
    """Merge (seq_name, chunk_idx, sequence) records into per-contig
    sequences (mergeContigChunkz, stitching.c:1413-1499). Returns
    [(contig, sequence)] in first-appearance order."""
    chunks = sorted(chunks, key=lambda t: t[1])
    out = []
    i = 0
    while i < len(chunks):
        name = chunks[i][0]
        j = i
        pieces: List[str] = []
        prev = chunks[i][2]
        j += 1
        while j < len(chunks) and chunks[j][0] == name:
            cur = chunks[j][2]
            prev, cur, _w = trim_adjacent_sequences(prev, cur, params,
                                                    device)
            pieces.append(prev)
            prev = cur
            j += 1
        pieces.append(prev)
        out.append((name, "".join(pieces)))
        i = j
    return out
