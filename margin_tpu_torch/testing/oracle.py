"""Band construction of the reference's banded pair-HMM
(pairwiseAligner.c:90-226), copied from the JAX package's numpy oracle:
the only part of it the port's banded path needs."""

from __future__ import annotations

import numpy as np


def _set_diags_vec(xs: np.ndarray, xl: int, yl: int, xu: int, yu: int):
    """set_diag (pairwiseAligner.c:90-113) vectorized over diagonals."""
    d = xl - yl
    xmy_l = d + ((xs + d) & 1)
    i = (xs + xmy_l) >> 1
    xmy_l = np.where(i < xl, xmy_l + 2 * (xl - i), xmy_l)
    j = (xs - xmy_l) >> 1
    xmy_l = np.where(yl < j, xmy_l + 2 * (j - yl), xmy_l)
    d = xu - yu
    xmy_r = d + ((xs + d) & 1)
    i = (xs + xmy_r) >> 1
    xmy_r = np.where(xu < i, xmy_r - 2 * (i - xu), xmy_r)
    j = (xs - xmy_r) >> 1
    xmy_r = np.where(j < yu, xmy_r - 2 * (yu - j), xmy_r)
    return xmy_l, xmy_r


def build_band(anchors, lx: int, ly: int, expansion: int,
               dynamic: bool = False):
    """Band construction (pairwiseAligner.c:175-226 fixed;
    :120-173 dynamic): per-diagonal [xmyL, xmyR] ranges from anchor pairs
    (x, y[, expansion]). With dynamic=True the expansion comes from each
    anchor's third element (band_constructDynamic). Returns int64 array
    (lx+ly+1, 2).

    Band corner parameters change only when an anchor is consumed, so the
    corner sets are computed for all consumptions at once and every
    diagonal gathers its segment's corners — fully vectorized even for
    dense (per-position) anchor ladders."""
    total = lx + ly
    diags = np.zeros((total + 1, 2), dtype=np.int64)
    n = len(anchors)

    # consumption targets: each anchor, then the terminal corner (lx, ly)
    if n:
        arr = np.asarray(anchors, dtype=np.int64)
        ax = np.concatenate([arr[:, 0] + 1, [lx]])
        ay = np.concatenate([arr[:, 1] + 1, [ly]])
        if dynamic:
            exps = np.concatenate([arr[:, 2],
                                   [arr[-1, 2]]])  # terminal keeps last exp
        else:
            exps = np.full(n + 1, expansion, dtype=np.int64)
    else:
        ax = np.array([lx], dtype=np.int64)
        ay = np.array([ly], dtype=np.int64)
        exps = np.array([0 if dynamic else expansion], dtype=np.int64)

    nxay = ax + ay
    nxmy = ax - ay
    pxay = np.concatenate([[0], nxay[:-1]])
    pxmy = np.concatenate([[0], nxmy[:-1]])
    # corner set c_i produced by consumption i (pairwiseAligner.c:199-222)
    xl = np.clip((pxay + pxmy - exps) // 2, 0, lx)
    yl = np.clip((nxay - (nxmy - exps)) // 2, 0, ly)
    xu = np.clip((nxay + nxmy + exps) // 2, 0, lx)
    yu = np.clip((pxay - (pxmy + exps)) // 2, 0, ly)

    # diagonal d in (b_{i-1}, b_i] uses c_{i-1}; b = consumption diagonals
    if total > 0:
        xs = np.arange(1, total + 1)
        seg = np.searchsorted(nxay, xs, side="left")
        seg = np.minimum(seg, len(nxay) - 1)
        l, r = _set_diags_vec(xs, xl[seg], yl[seg], xu[seg], yu[seg])
        diags[1:, 0] = l
        diags[1:, 1] = r
    # diagonal 0 uses the pre-consumption zero corners: (0, 0)
    return diags
