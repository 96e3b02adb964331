"""Depth downsampling via a single-constraint LP == fractional knapsack.

Parity: computeReadProbsByLengthAndSecondMetric (htsIntegration.c:957-1011)
solves  max Σ p_i·metric_i  s.t.  Σ l_i·p_i = C·L, 0 <= p_i <= 1.
That LP is a fractional knapsack: its vertex optimum sets p=1 for reads in
descending metric/length ratio until the budget C·L is spent, a fractional
p for the marginal read, 0 for the rest — so we solve it by sorting rather
than shipping an LP solver. Reads are then kept by Bernoulli(p)
(downsampleBamChunkReadWithVcfEntrySubstringsViaFullReadLengthLikelihood,
htsIntegration.c:1141-1216).
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np


def knapsack_probs(lengths: np.ndarray, metrics: np.ndarray,
                   target_coverage: float, region_length: int) -> np.ndarray:
    """Optimal p in [0,1]^n for the LP above."""
    lengths = np.asarray(lengths, dtype=np.float64)
    metrics = np.asarray(metrics, dtype=np.float64)
    n = len(lengths)
    budget = target_coverage * region_length
    probs = np.zeros(n)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(lengths > 0, metrics / np.maximum(lengths, 1e-300), np.inf)
    # zero-length reads contribute nothing to the constraint; take any with
    # positive metric for free
    order = np.argsort(-ratio, kind="stable")
    remaining = budget
    for i in order:
        li = lengths[i]
        if li <= 0:
            probs[i] = 1.0 if metrics[i] > 0 else 0.0
            continue
        if remaining <= 0:
            break
        p = min(1.0, remaining / li)
        probs[i] = p
        remaining -= p * li
    return probs


def downsample_reads_by_vcf_spans(intended_depth: int, num_chunk_vcf_entries: int,
                                  reads: List, rng: random.Random) -> Tuple[List, List, bool]:
    """Phase-path downsampling (htsIntegration.c:1141-1216): 'length' = the
    number of variants a read spans, metric = full aligned read length,
    region length = chunk variant count. Returns (kept, discarded, did)."""
    if not reads:
        return reads, [], False
    lengths = np.array([len(r.vcf_entries) for r in reads], dtype=np.int64)
    metrics = np.array([r.full_read_length for r in reads], dtype=np.int64)
    total = int(lengths.sum())
    if num_chunk_vcf_entries > 0:
        avg = total / num_chunk_vcf_entries
        if avg < intended_depth:
            return reads, [], False
    if num_chunk_vcf_entries == 0 or total == 0:
        # degenerate chunk: discard everything (htsIntegration.c:1174-1186)
        return [], list(reads), True
    probs = knapsack_probs(lengths, metrics, intended_depth, num_chunk_vcf_entries)
    kept, discarded = [], []
    for r, p in zip(reads, probs):
        (kept if rng.random() < p else discarded).append(r)
    return kept, discarded, True
