"""Bayesian run-length (repeat count) inference over POA observations.

Copy of `margin_tpu/polish/repeats.py` with the port's imports. Parity:
impl/repeatSubMatrix.c (ML and phased-ML repeat counts) and the mode
fallback (poa.c:1678-1698), host-side numpy.
"""

from __future__ import annotations

from typing import List, Optional, Set

import numpy as np

from margin_tpu_torch.alphabet import seq_to_symbols
from margin_tpu_torch.params import PolishParams, RepeatSubMatrix
from margin_tpu_torch.polish.poa import PAIR1, Poa, PoaRead


def _observed_counts_and_weights(node, reads: List[PoaRead], max_rl: int):
    obs = node.observations
    if not obs:
        return None, None, None
    counts = np.empty(len(obs), dtype=np.int64)
    weights = np.empty(len(obs), dtype=np.float64)
    strands = np.empty(len(obs), dtype=bool)
    for i, (read_no, offset, weight) in enumerate(obs):
        r = reads[read_no]
        counts[i] = min(int(r.rle_read.counts[offset]), max_rl - 1)
        weights[i] = weight
        strands[i] = r.forward_strand
    return counts, weights, strands


def _log_probs_for_counts(rm: RepeatSubMatrix, base: int, counts, weights,
                          strands, lo: int, hi: int) -> np.ndarray:
    """repeatSubMatrix_getRepeatCountProbs (repeatSubMatrix.c:115-122):
    log prob of each underlying count in [lo, hi]."""
    b = base if base < 4 else 0
    fwd_slot = b
    rev_slot = 3 - b
    # (hi-lo+1, n_obs) gather: logProb[underlying, obs]
    under = np.arange(lo, hi + 1)
    probs_f = rm.log_probs[fwd_slot][under[:, None], counts[None, :]]
    probs_r = rm.log_probs[rev_slot][under[:, None], counts[None, :]]
    sel = np.where(strands[None, :], probs_f, probs_r)
    return (sel * weights[None, :]).sum(axis=1) / PAIR1


def ml_repeat_count(rm: Optional[RepeatSubMatrix], poa: Poa, node,
                    reads: List[PoaRead]) -> int:
    """repeatSubMatrix_getMLRepeatCount (repeatSubMatrix.c:124-143) or the
    mode of observed run lengths when no matrix (poa.c:1678-1698)."""
    base = seq_to_symbols(node.base)[0]
    if rm is None:
        # mode of observed run lengths among matching-base observations
        tallies = {}
        best_rl, best_n = 0, 0
        for read_no, offset, _w in node.observations:
            r = reads[read_no]
            if seq_to_symbols(r.rle_read.bases[offset])[0] != base:
                continue
            rl = int(r.rle_read.counts[offset])
            n = tallies.get(rl, 0) + 1
            tallies[rl] = n
            if n > best_n:
                best_n, best_rl = n, rl
        return best_rl
    counts, weights, strands = _observed_counts_and_weights(node, reads, rm.max_repeat)
    if counts is None or len(counts) == 0 or counts.min() == rm.max_repeat:
        return 0
    lo, hi = int(counts.min()), int(counts.max())
    lp = _log_probs_for_counts(rm, int(base), counts, weights, strands, lo, hi)
    return lo + int(np.argmax(lp))  # first max (getMax, repeatSubMatrix.c:153-167)


class _FlatObs:
    """All node observations flattened once (the per-node tuple-unpack loop
    dominated estimate_repeat_counts' host time): per-node slices of
    observed-count / weight / strand arrays, numerically identical inputs
    to the per-node path."""

    def __init__(self, lens, read_nos, offsets, weights,
                 reads: List[PoaRead], max_rl: int):
        self.starts = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=self.starts[1:])
        if int(self.starts[-1]) == 0:
            self.counts = np.zeros(0, np.int64)
            self.weights = np.zeros(0, np.float64)
            self.strands = np.zeros(0, bool)
            return
        self.weights = weights
        read_lens = np.fromiter((r.rle_read.length for r in reads),
                                dtype=np.int64, count=len(reads))
        base_off = np.zeros(len(reads) + 1, dtype=np.int64)
        np.cumsum(read_lens, out=base_off[1:])
        big_counts = (np.concatenate([r.rle_read.counts for r in reads])
                      if reads else np.zeros(0, np.int64))
        self.counts = np.minimum(big_counts[base_off[read_nos] + offsets],
                                 max_rl - 1)
        strand_per_read = np.fromiter((r.forward_strand for r in reads),
                                      dtype=bool, count=len(reads))
        self.strands = strand_per_read[read_nos]
        self.read_nos = read_nos

    @classmethod
    def of_nodes(cls, nodes, reads: List[PoaRead], max_rl: int):
        """From the nodes' observation tuples."""
        lens = np.fromiter((len(n.observations) for n in nodes),
                           dtype=np.int64, count=len(nodes))
        flat = np.array([o for n in nodes for o in n.observations],
                        dtype=np.float64).reshape(-1, 3)
        return cls(lens, flat[:, 0].astype(np.int64),
                   flat[:, 1].astype(np.int64), flat[:, 2].copy(), reads,
                   max_rl)

    @classmethod
    def of_poa(cls, poa: Poa, reads: List[PoaRead], max_rl: int):
        """Of poa.nodes[1:], from the columns where the graph has them
        (in the tuples' order), else from the tuples."""
        if poa._cols is None:
            return cls.of_nodes(poa.nodes[1:], reads, max_rl)
        lens, rn, off, wt = poa._cols.node_observations()
        skip = int(lens[0])
        return cls(lens[1:], rn[skip:], off[skip:], wt[skip:], reads, max_rl)

    def node(self, i: int):
        s, e = self.starts[i], self.starts[i + 1]
        if s == e:
            return None, None, None
        return self.counts[s:e], self.weights[s:e], self.strands[s:e]


def estimate_repeat_counts(poa: Poa, reads: List[PoaRead],
                           rm: Optional[RepeatSubMatrix]):
    """poa_estimateRepeatCountsUsingBayesianModel (poa.c:1715-1727)."""
    counts = poa.ref_string.counts
    if rm is None:
        for i, node in enumerate(poa.nodes[1:]):
            rc = ml_repeat_count(rm, poa, node, reads)
            counts[i] = max(rc, 1)
            node.repeat_count = int(counts[i])
        poa.ref_string.non_rle_length = int(counts.sum())
        return
    flat = _FlatObs.of_poa(poa, reads, rm.max_repeat)
    bases = seq_to_symbols(poa.ref_string.bases).astype(np.int64)
    for i in range(len(bases)):
        cnt, wts, strs = flat.node(i)
        if cnt is None or cnt.min() == rm.max_repeat:
            rc = 0
        else:
            lo, hi = int(cnt.min()), int(cnt.max())
            lp = _log_probs_for_counts(rm, int(bases[i]), cnt, wts, strs,
                                       lo, hi)
            rc = lo + int(np.argmax(lp))
        counts[i] = max(rc, 1)
    _set_node_repeat_counts(poa)
    poa.ref_string.non_rle_length = int(counts.sum())


def _set_node_repeat_counts(poa: Poa):
    """Copy ref_string.counts into the nodes where they have been built (a
    later build takes them from ref_string)."""
    nodes = poa.built_nodes()
    if nodes is not None:
        for node, rc in zip(nodes[1:], poa.ref_string.counts.tolist()):
            node.repeat_count = rc


def phased_ml_repeat_count(rm: RepeatSubMatrix, node, reads: List[PoaRead],
                           hap1_ids: Set[int], params: PolishParams) -> int:
    """repeatSubMatrix_getPhasedMLRepeatCount (repeatSubMatrix.c:169-238):
    hap2 observations act as a prior with a het-substitution escape."""
    from margin_tpu_torch.alphabet import seq_to_symbols as s2s
    base = int(s2s(node.base)[0])
    counts, weights, strands = _observed_counts_and_weights(node, reads, rm.max_repeat)
    if counts is None or len(counts) == 0 or counts.min() == rm.max_repeat:
        return 0
    lo, hi = int(counts.min()), int(counts.max())
    in_h1 = np.array([id(reads[o[0]]) in hap1_ids for o in node.observations])
    lp1 = _log_probs_for_counts(rm, base, counts[in_h1], weights[in_h1],
                                strands[in_h1], lo, hi)
    lp2 = _log_probs_for_counts(rm, base, counts[~in_h1], weights[~in_h1],
                                strands[~in_h1], lo, hi)
    ml2 = float(lp2.max())
    esc = np.log(params.hetRunLengthSubstitutionProbability)
    combined = lp1 + np.maximum(lp2, ml2 + esc)
    # >= comparison in the loop -> last max wins (repeatSubMatrix.c:211-220)
    best = lo
    best_p = combined[0]
    for i in range(1, len(combined)):
        if combined[i] >= best_p:
            best_p = combined[i]
            best = lo + i
    return best


def estimate_phased_repeat_counts(poa: Poa, reads: List[PoaRead],
                                  rm: RepeatSubMatrix, hap1_ids: Set[int],
                                  params: PolishParams):
    """poa_estimatePhasedRepeatCountsUsingBayesianModel (poa.c:1729-1756).
    Observations are flattened once (_FlatObs); the per-node float path
    (_log_probs_for_counts + the last-max-wins scan) is unchanged."""
    counts = poa.ref_string.counts
    flat = _FlatObs.of_poa(poa, reads, rm.max_repeat)
    in_h1_read = np.fromiter((id(r) in hap1_ids for r in reads),
                             dtype=bool, count=len(reads))
    bases = seq_to_symbols(poa.ref_string.bases).astype(np.int64)
    esc = np.log(params.hetRunLengthSubstitutionProbability)
    for i in range(len(bases)):
        cnt, wts, strs = flat.node(i)
        if cnt is None or cnt.min() == rm.max_repeat:
            rc = 0
        else:
            s, e = flat.starts[i], flat.starts[i + 1]
            in_h1 = in_h1_read[flat.read_nos[s:e]]
            lo, hi = int(cnt.min()), int(cnt.max())
            base = int(bases[i])
            lp1 = _log_probs_for_counts(rm, base, cnt[in_h1], wts[in_h1],
                                        strs[in_h1], lo, hi)
            lp2 = _log_probs_for_counts(rm, base, cnt[~in_h1], wts[~in_h1],
                                        strs[~in_h1], lo, hi)
            ml2 = float(lp2.max())
            combined = lp1 + np.maximum(lp2, ml2 + esc)
            # >= comparison -> last max wins (repeatSubMatrix.c:211-220)
            rc = lo
            best_p = combined[0]
            for k in range(1, len(combined)):
                if combined[k] >= best_p:
                    best_p = combined[k]
                    rc = lo + k
        counts[i] = max(rc, 1)
    _set_node_repeat_counts(poa)
    poa.ref_string.non_rle_length = int(counts.sum())
