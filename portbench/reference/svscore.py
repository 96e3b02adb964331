"""Margin's support of an SV allele by a read substring, in plain numpy and
float64 PyTorch: the k-mer anchors of the pair, margin's band around them
and the banded forward total over it. It imports nothing of the program.

Margin scores an (allele, read substring) pair either side of which is
longer than `referenceExpansionForStructuralVariants` with the banded
pair-HMM on k-mer anchors (bubbleGraph.c:1447-1453). The anchors are
`getKmerAlignmentAnchors` (pairwiseAligner.c, declared at
pairwiseAligner.h:321), written here anew from its description:

  * every k-mer (k = 20) of X, the allele, is keyed by its symbols; only
    its first occurrence in X counts;
  * walking Y, the read substring, from its first k-mer to its last, each
    k-mer found in X gives a match (x, y): one a y at most, y ascending;
  * the matches are chained: a match extends the best chain of an earlier
    match with a smaller x, scanning the earlier matches from the nearest
    back and stopping after the first such match that set a new best
    score when it was made (margin's high-score shortcut); the chain that
    ends at the last match reaching the best score wins, followed back
    through its back-pointers;
  * each match of the chain is an anchor at the k-mer's centre,
    (x + k/2, y + k/2, expansion).

Departures from margin: k-mers are keyed by their exact symbols packed
into an integer, where margin hashes the symbol string and compares it;
symbols (0-4, N = 4) are taken as they come, as margin's symbol strings
hold them. The band is `pairhmm.build_band` of those anchors and the
total `pairhmm.banded_posteriors`' (a forward-backward whose backward is
not needed for a total; kept so that one banded recurrence serves the
benchmark).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from portbench.reference import pairhmm

KMER = 20
_BITS = 3           # bits a symbol (0-7) in a packed k-mer key


def _kmer_keys(s: np.ndarray, k: int) -> np.ndarray:
    """The packed key of each k-mer of s, by start."""
    s = np.asarray(s, dtype=np.int64)
    n = len(s) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    if s.size and (s.min() < 0 or s.max() >= 1 << _BITS):
        raise ValueError("symbols outside 0-7")
    keys = np.zeros(n, dtype=np.int64)
    for t in range(k):
        keys = (keys << _BITS) | s[t:t + n]
    return keys


def kmer_matches(x: np.ndarray, y: np.ndarray, k: int = KMER):
    """(xs, ys): for each k-mer of y, in order, that occurs in x, the start
    of its first occurrence in x and its own start."""
    kx, ky = _kmer_keys(x, k), _kmer_keys(y, k)
    if not len(kx) or not len(ky):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    uniq, first = np.unique(kx, return_index=True)   # first: lowest start
    at = np.minimum(np.searchsorted(uniq, ky), len(uniq) - 1)
    hit = uniq[at] == ky
    return first[at[hit]].astype(np.int64), np.nonzero(hit)[0].astype(
        np.int64)


def chain(xs: np.ndarray) -> List[int]:
    """Margin's chain over matches in y order: indices of the chosen
    matches, first to last."""
    xs = [int(v) for v in xs]
    n = len(xs)
    if not n:
        return []
    score = [1] * n
    back = [-1] * n
    set_best = [False] * n
    best, best_end = 0, -1
    for i in range(n):
        j = i - 1
        while j >= 0:
            if xs[j] < xs[i]:
                if score[j] + 1 > score[i]:
                    score[i], back[i] = score[j] + 1, j
                if set_best[j]:
                    break
            j -= 1
        if score[i] >= best:
            best, best_end, set_best[i] = score[i], i, True
    out = []
    while best_end != -1:
        out.append(best_end)
        best_end = back[best_end]
    return out[::-1]


def kmer_anchors(x: np.ndarray, y: np.ndarray, expansion: int,
                 k: int = KMER) -> List[Tuple[int, int, int]]:
    """getKmerAlignmentAnchors: (x, y, expansion) anchors of the pair."""
    if k > len(x) or k > len(y):
        return []
    xs, ys = kmer_matches(x, y, k)
    return [(int(xs[i]) + k // 2, int(ys[i]) + k // 2, int(expansion))
            for i in chain(xs)]


def totals(tabs, pairs: List[dict], expansion: int, lut: bool,
           dtype=torch.float64, device="cpu",
           budget_bytes: float = 2.5e8) -> np.ndarray:
    """The banded forward total of each pair (dicts with x, y, strand and,
    for RLE, rep_x / rep_y), on the band of its own k-mer anchors,
    computed from the pair alone. Pairs go in batches of like band width
    whose posterior grid stays within budget_bytes."""
    out = np.zeros(len(pairs))
    items, sizes = [], []
    for p in pairs:
        x = np.asarray(p["x"], np.int64)
        y = np.asarray(p["y"], np.int64)
        anchors = kmer_anchors(x, y, expansion)
        band = pairhmm.build_band(anchors, len(x), len(y), expansion)
        w = int(((band[:, 1] - band[:, 0]) // 2 + 1).max())
        items.append({"x_sym": x, "y_sym": y, "anchors": anchors,
                      "strand": int(p["strand"]),
                      "rep_x": p.get("rep_x"), "rep_y": p.get("rep_y")})
        sizes.append((len(x) + len(y) + 1, w))
    elem = torch.tensor([], dtype=dtype).element_size()
    order = sorted(range(len(pairs)), key=lambda i: sizes[i][::-1])
    batch: List[int] = []
    d_max = w_max = 0

    def flush():
        if batch:
            res = pairhmm.banded_posteriors(tabs, [items[i] for i in batch],
                                            expansion, lut, False, dtype,
                                            device)
            out[batch] = res.totals
    for i in order:
        d, w = sizes[i]
        nd, nw = max(d_max, d), max(w_max, w)
        if batch and (len(batch) + 1) * nd * 3 * (nw + 1) * elem \
                > budget_bytes:
            flush()
            batch, nd, nw = [], d, w
        batch.append(i)
        d_max, w_max = nd, nw
    flush()
    return out
