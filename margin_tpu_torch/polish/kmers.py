"""K-mer chain alignment anchors.

Parity: getKmerAlignmentAnchors (pairwiseAligner.c:1519-1627): 20-mers of X
hashed first-occurrence-only, shared k-mers chained by an O(n^2)-with-
high-score-shortcut LIS, anchors returned at kmer midpoints with a given
expansion."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

KMER_SIZE = 20


def get_kmer_alignment_anchors(x_sym: np.ndarray, y_sym: np.ndarray,
                               anchor_expansion: int,
                               kmer_size: int = KMER_SIZE) -> List[Tuple[int, int, int]]:
    lx, ly = len(x_sym), len(y_sym)
    if kmer_size > lx or kmer_size > ly:
        return []
    x = np.asarray(x_sym, dtype=np.int64)
    y = np.asarray(y_sym, dtype=np.int64)

    # rolling polynomial hashes would risk collisions differing from the
    # reference's exact-compare hash; use python bytes keys (exact)
    xb = x.astype(np.uint8).tobytes()
    yb = y.astype(np.uint8).tobytes()
    occurrences = {}
    for i in range(lx - kmer_size + 1):
        k = xb[i:i + kmer_size]
        if k not in occurrences:  # first hit counts (pairwiseAligner.c:1547-1552)
            occurrences[k] = i

    xs, ys = [], []
    for j in range(ly - kmer_size + 1):
        i = occurrences.get(yb[j:j + kmer_size])
        if i is not None:
            xs.append(i)
            ys.append(j)
    n = len(xs)
    if n == 0:
        return []

    score = np.ones(n, dtype=np.int64)
    backptr = np.full(n, -1, dtype=np.int64)
    high = np.zeros(n, dtype=bool)
    max_score = 0
    max_pair = -1
    for i in range(n):
        for j in range(i - 1, -1, -1):
            if xs[j] < xs[i]:
                if score[j] + 1 > score[i]:
                    score[i] = score[j] + 1
                    backptr[i] = j
                if high[j]:
                    break
        if score[i] >= max_score:
            high[i] = True
            max_score = score[i]
            max_pair = i

    anchors = []
    k = max_pair
    half = kmer_size // 2
    while k != -1:
        anchors.append((xs[k] + half, ys[k] + half, anchor_expansion))
        k = backptr[k]
    anchors.reverse()
    return anchors
