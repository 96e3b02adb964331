"""Plain PyTorch pair-HMM: the dense forward total (what kernel K1
computes) and the banded forward-backward posteriors (what K2, K3 and the
host banded engine compute), written from margin's recurrence
(pairwiseAligner.c, stateMachine.c:521-586) in a precision of the
caller's choice. It imports nothing of the program.

Cells are (x, y): x characters of the first sequence (X, the reference
side) and y of the second (Y, the read) consumed. With e the emissions
and T the transitions (hmm.py's layout):

    M(x, y)  = e_m(X[x-1], Y[y-1]) + logAdd(M, GX, GY at (x-1, y-1)
                                             + T_MM, T_M_FROM_GX, T_M_FROM_GY)
    GX(x, y) = e_gx(X[x-1]) + logAdd(M, GX, GY at (x-1, y)
                                     + T_OPEN_X, T_EXT_X, T_SW_X)
    GY(x, y) = e_gy(Y[y-1]) + logAdd(M, GY, GX at (x, y-1)
                                     + T_OPEN_Y, T_EXT_Y, T_SW_Y)

started at (0, 0) in match (ragged left: in both gaps) and ended at
(lx, ly) with T_MM, T_M_FROM_GX, T_M_FROM_GY (ragged right: the mean of
the two gap opens, T_EXT_X, T_EXT_Y). Every value is held at or above
LOG_ZERO. logAdd is margin's piecewise cubic LUT (pairwiseAligner.c:
279-299) or the exact one. The banded form keeps the cells of the band
margin builds from the anchors (pairwiseAligner.c:90-226, `build_band`);
a cell's posterior is exp(min(f + b - total, 0)).

Diagonals are indexed by d = x + y and cells on them by xmy = x - y.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from portbench.reference.hmm import (LOG_ZERO, REPEAT, T_EXT_X, T_EXT_Y,
                                     T_M_FROM_GX, T_M_FROM_GY, T_MM,
                                     T_OPEN_X, T_OPEN_Y, T_SW_X, T_SW_Y,
                                     Tables)

# pairwiseAligner.c:282-293: rows for d <= 1.0, 2.5, 4.5, 7.5 of
# ((a*d + b)*d + c)*d + e ~ log(exp(d) + 1)
CUBIC = np.array([
    [-0.009350833524763, 0.130659527668286, 0.498799810682272,
     0.693203116424741],
    [-0.014532321752540, 0.139942324101744, 0.495635523139337,
     0.692140569840976],
    [-0.004605031767994, 0.063427417320019, 0.695956496475118,
     0.514272634594009],
    [-0.000458661602210, 0.009695946122598, 0.930734667215156,
     0.168037164329057]])
BREAKS = (1.0, 2.5, 4.5)
UNDERFLOW = 7.5


class LogAdd:
    """logAdd(a, b) on tensors of one dtype and device."""

    def __init__(self, lut: bool, dtype, device):
        self.lut = lut
        self.c = torch.tensor(CUBIC, dtype=dtype, device=device)
        self.breaks = torch.tensor(BREAKS, dtype=dtype, device=device)

    def __call__(self, a, b):
        if not self.lut:
            return torch.logaddexp(a, b)
        hi, lo = torch.maximum(a, b), torch.minimum(a, b)
        d = hi - lo
        c = self.c[torch.bucketize(d, self.breaks)]   # row: d <= 1, 2.5, 4.5
        approx = torch.addcmul(c[..., 1], c[..., 0], d)
        approx = torch.addcmul(c[..., 2], approx, d)
        approx = torch.addcmul(c[..., 3], approx, d)
        return torch.where(d >= UNDERFLOW, hi, approx + lo)

    def three(self, a, b, c):
        return self(self(a, b), c)


def _strand_tables(tabs: Tables, strands, dtype, device):
    s = np.asarray(strands, np.int64)

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)
    return (t(tabs.match[s].reshape(len(s), 25)), t(tabs.gap_x[s]),
            t(tabs.gap_y[s]), t(tabs.trans[s]),
            None if tabs.repeat is None
            else t(tabs.repeat[s].reshape(len(s), -1)))


def _end_weights(tr, ragged_right):
    rr = ragged_right[:, None]
    normal = torch.stack([tr[:, T_MM], tr[:, T_M_FROM_GX],
                          tr[:, T_M_FROM_GY]], 1)
    ragged = torch.stack([(tr[:, T_OPEN_X] + tr[:, T_OPEN_Y]) / 2.0,
                          tr[:, T_EXT_X], tr[:, T_EXT_Y]], 1)
    return torch.where(rr, ragged, normal)                      # (B, 3)


def _pad_rows(seqs, width, fill, dtype=np.int64):
    out = np.full((len(seqs), width), fill, dtype=dtype)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out


class _Seqs:
    """The batch's sequences padded with N (4) and run length 0, one
    column of padding before the first character, so that index i + 1
    reads character i and any index out of range reads N."""

    def __init__(self, pairs, device):
        lx = max(max(len(p["x"]) for p in pairs), 1)
        ly = max(max(len(p["y"]) for p in pairs), 1)
        self.lx = torch.tensor([len(p["x"]) for p in pairs], device=device)
        self.ly = torch.tensor([len(p["y"]) for p in pairs], device=device)
        self.Lx, self.Ly = lx, ly

        def pad(key, fill, width):
            rows = [np.concatenate([[fill], np.asarray(p[key], np.int64),
                                    [fill]]) if p.get(key) is not None
                    else np.full(len(p["x" if key[-1] == "x" else "y"]) + 2,
                                 fill) for p in pairs]
            return torch.tensor(_pad_rows(rows, width + 2, fill),
                                device=device)
        self.x = pad("x", 4, lx)
        self.y = pad("y", 4, ly)
        self.rle = pairs[0].get("rep_x") is not None
        if self.rle:
            self.rx = pad("rep_x", 0, lx).clamp(max=REPEAT - 1)
            self.ry = pad("rep_y", 0, ly).clamp(max=REPEAT - 1)

    def at(self, xi, yi):
        """Symbols (and run lengths) of X[xi - 1] and Y[yi - 1]; N beyond
        the sequences. xi, yi: (B, W) int64."""
        xi = xi.clamp(0, self.Lx + 1)
        yi = yi.clamp(0, self.Ly + 1)
        sx = torch.gather(self.x, 1, xi)
        sy = torch.gather(self.y, 1, yi)
        if not self.rle:
            return sx, sy, None, None
        return sx, sy, torch.gather(self.rx, 1, xi), torch.gather(
            self.ry, 1, yi)


def _emissions(m_tab, gx_tab, gy_tab, rep_tab, seqs, xi, yi):
    """(e_m, e_gx, e_gy), each (B, W), of cells consuming X[xi - 1] and
    Y[yi - 1]."""
    sx, sy, rx, ry = seqs.at(xi, yi)
    e_m = torch.gather(m_tab, 1, sx * 5 + sy)
    if rep_tab is not None:
        base = torch.where(sx >= 4, 0, sx)
        e_m = e_m + torch.gather(rep_tab, 1, base * (REPEAT * REPEAT)
                                 + rx * REPEAT + ry)
    return e_m, torch.gather(gx_tab, 1, sx), torch.gather(gy_tab, 1, sy)


def _trans_stacks(tr, fwd: bool):
    """(3 terms) of (B, 3 states, 1) transitions. Forward: per target
    state (m, gx, gy) the terms from the source cell's (m, gx, gy) of
    (x-1, y-1), (x-1, y) and (x, y-1) taken as (m, gx, gy), (m, gx, gy)
    and (m, gy, gx). Backward: per source state the terms to the
    successors gap X (x+1, y), match (x+1, y+1) and gap Y (x, y+1)."""
    if fwd:
        idx = ((T_MM, T_OPEN_X, T_OPEN_Y), (T_M_FROM_GX, T_EXT_X, T_EXT_Y),
               (T_M_FROM_GY, T_SW_X, T_SW_Y))
    else:
        idx = ((T_OPEN_X, T_EXT_X, T_SW_X), (T_MM, T_M_FROM_GX, T_M_FROM_GY),
               (T_OPEN_Y, T_SW_Y, T_EXT_Y))
    return [tr[:, list(row)][:, :, None] for row in idx]


def dense_forward_totals(tabs: Tables, pairs: List[dict], lut: bool,
                         dtype=torch.float64, device="cpu") -> np.ndarray:
    """Total forward log-probability of each pair (dicts with x, y
    symbol arrays 0-4, strand, ragged_left, ragged_right and, for RLE,
    rep_x / rep_y), over the whole rectangle. Returns float64 (B,)."""
    if not pairs:
        return np.zeros(0)
    la = LogAdd(lut, dtype, device)
    B = len(pairs)
    seqs = _Seqs(pairs, device)
    m_tab, gx_tab, gy_tab, tr, rep = _strand_tables(
        tabs, [p["strand"] for p in pairs], dtype, device)
    if tabs.repeat is None or not seqs.rle:
        rep = None
    neg = torch.tensor(LOG_ZERO, dtype=dtype, device=device)
    z = torch.zeros((), dtype=dtype, device=device)
    rl = torch.tensor([bool(p.get("ragged_left")) for p in pairs],
                      device=device)
    rr = torch.tensor([bool(p.get("ragged_right")) for p in pairs],
                      device=device)
    end_w = _end_weights(tr, rr)
    t1, t2, t3 = _trans_stacks(tr, fwd=True)
    W = seqs.Ly + 1
    # diagonal d holds rows y = 0..Ly, row y the cell (d - y, y); p1, p2
    # the two diagonals before, (B, 3 states, W)
    y = torch.arange(W, device=device)[None, :]                 # (1, W)
    init = torch.stack([torch.where(rl, neg, z), torch.where(rl, z, neg),
                        torch.where(rl, z, neg)], 1)[:, :, None]
    p1 = torch.where((y == 0)[:, None, :], init, neg)
    p2 = neg.expand(B, 3, W)
    lx, ly = seqs.lx[:, None], seqs.ly[:, None]
    final = seqs.lx + seqs.ly
    total = torch.full((B,), LOG_ZERO, dtype=dtype, device=device)
    negcol = neg.expand(B, 3, 1)
    swap = torch.tensor([0, 2, 1], device=device)

    def up(a):          # row y <- row y - 1
        return torch.cat([negcol, a[:, :, :-1]], 2)
    for d in range(1, seqs.Lx + seqs.Ly + 1):
        x = (d - y).expand(B, W)
        e_m, e_gx, e_gy = _emissions(m_tab, gx_tab, gy_tab, rep, seqs, x,
                                     y.expand(B, W))
        # per target state (m, gx, gy): its source cell's three states
        src = torch.stack([up(p2), p1, up(p1).index_select(1, swap)], 1)
        new = torch.stack([e_m, e_gx, e_gy], 1) + la.three(
            src[:, :, 0] + t1, src[:, :, 1] + t2, src[:, :, 2] + t3)
        valid = ((x >= 0) & (x <= lx) & (y <= ly))[:, None, :]
        new = torch.maximum(torch.where(valid, new, neg), neg)
        hit = final == d
        if bool(hit.any()):
            f = torch.where((y == ly)[:, None, :], new, neg).amax(2)
            tot = la.three(f[:, 0] + end_w[:, 0], f[:, 1] + end_w[:, 1],
                           f[:, 2] + end_w[:, 2])
            total = torch.where(hit, tot, total)
        p2, p1 = p1, new
    total = torch.where(final == 0, torch.zeros_like(total), total)
    return total.double().cpu().numpy()


# ---------------------------------------------------------------------------
# the band and the banded forward-backward
# ---------------------------------------------------------------------------

def _set_diags(xs, xl, yl, xu, yu):
    """set_diag (pairwiseAligner.c:90-113) over diagonals xs."""
    d = xl - yl
    lo = d + ((xs + d) & 1)
    i = (xs + lo) >> 1
    lo = np.where(i < xl, lo + 2 * (xl - i), lo)
    j = (xs - lo) >> 1
    lo = np.where(yl < j, lo + 2 * (j - yl), lo)
    d = xu - yu
    hi = d + ((xs + d) & 1)
    i = (xs + hi) >> 1
    hi = np.where(xu < i, hi - 2 * (i - xu), hi)
    j = (xs - hi) >> 1
    hi = np.where(j < yu, hi - 2 * (yu - j), hi)
    return lo, hi


def build_band(anchors, lx: int, ly: int, expansion: int,
               dynamic: bool = False) -> np.ndarray:
    """Margin's band (pairwiseAligner.c:120-226): per diagonal d the xmy
    range [lo, hi] around the anchor pairs (x, y[, expansion]), widened by
    `expansion` (with dynamic=True, each anchor's own). (lx+ly+1, 2)."""
    total = lx + ly
    out = np.zeros((total + 1, 2), dtype=np.int64)
    anchors = [] if anchors is None else anchors
    n = len(anchors)
    if n:
        arr = np.asarray(anchors, dtype=np.int64).reshape(n, -1)
        ax = np.concatenate([arr[:, 0] + 1, [lx]])
        ay = np.concatenate([arr[:, 1] + 1, [ly]])
        exps = (np.concatenate([arr[:, 2], [arr[-1, 2]]]) if dynamic
                else np.full(n + 1, expansion, dtype=np.int64))
    else:
        ax, ay = np.array([lx]), np.array([ly])
        exps = np.array([0 if dynamic else expansion], dtype=np.int64)
    nxay, nxmy = ax + ay, ax - ay
    pxay = np.concatenate([[0], nxay[:-1]])
    pxmy = np.concatenate([[0], nxmy[:-1]])
    xl = np.clip((pxay + pxmy - exps) // 2, 0, lx)
    yl = np.clip((nxay - (nxmy - exps)) // 2, 0, ly)
    xu = np.clip((nxay + nxmy + exps) // 2, 0, lx)
    yu = np.clip((pxay - (pxmy + exps)) // 2, 0, ly)
    if total > 0:
        xs = np.arange(1, total + 1)
        seg = np.minimum(np.searchsorted(nxay, xs, side="left"),
                         len(nxay) - 1)
        out[1:, 0], out[1:, 1] = _set_diags(xs, xl[seg], yl[seg], xu[seg],
                                            yu[seg])
    return out


class BandedResult:
    """A batch's posteriors: post (D+1, B, 3, W) on the device, with the
    band's storage base lo (B, D+1) and the totals (B,)."""

    def __init__(self, post, lo, totals, lx, ly):
        self.post, self.lo, self.totals = post, lo, totals
        self.lx, self.ly = lx, ly

    def lookup(self, b: int, state: int, x: np.ndarray, y: np.ndarray):
        """Posteriors of item b's cells (x, y) of one state; 0 outside the
        band."""
        d = x + y
        lo = self.lo[b].cpu().numpy()
        k = (x - y - lo[np.minimum(d, len(lo) - 1)]) // 2
        W = self.post.shape[3]
        ok = (d < len(lo)) & (k >= 0) & (k < W)
        out = np.zeros(len(x))
        if ok.any():
            dd = torch.as_tensor(d[ok], device=self.post.device)
            kk = torch.as_tensor(k[ok], device=self.post.device)
            out[ok] = self.post[dd, b, state, kk].double().cpu().numpy()
        return out

    def selected(self, b: int, threshold: float):
        """Item b's cells with posterior >= threshold, per state, as
        (value, x - 1, y - 1) float64 rows sorted by (x, y): the
        program's output layout, with the value unscaled. A match needs
        x, y > 0, a gap X x > 0, a gap Y y > 0."""
        D = int(self.lx[b] + self.ly[b])
        p = self.post[:D + 1, b]                               # (D+1, 3, W)
        dd, ss, kk = torch.nonzero(p >= threshold, as_tuple=True)
        vals = p[dd, ss, kk].double().cpu().numpy()
        dd, ss, kk = dd.cpu().numpy(), ss.cpu().numpy(), kk.cpu().numpy()
        xmy = self.lo[b].cpu().numpy()[dd] + 2 * kk
        x, y = (dd + xmy) // 2, (dd - xmy) // 2
        out = []
        for s, need_x, need_y in ((0, True, True), (1, True, False),
                                  (2, False, True)):
            m = ss == s
            if need_x:
                m &= x > 0
            if need_y:
                m &= y > 0
            rows = np.stack([vals[m], x[m] - 1.0, y[m] - 1.0], 1)
            out.append(rows[np.lexsort((rows[:, 2], rows[:, 1]))])
        return out


BLOCK = 2048      # diagonals whose geometry and emissions are made at once


def banded_posteriors(tabs: Tables, items: List[dict], expansion: int,
                      lut: bool, dynamic: bool = False,
                      dtype=torch.float64, device="cpu") -> BandedResult:
    """Forward-backward posteriors of a batch of items (dicts with x_sym,
    y_sym, anchors, strand, optional rep_x / rep_y, ragged_left /
    ragged_right) over each item's band, computed together, diagonal by
    diagonal. Each diagonal's cells sit at k = (xmy - lo[d]) / 2 in a
    row of W + 1 values whose last stays LOG_ZERO, so a cell outside the
    band reads LOG_ZERO; the geometry, emissions and neighbour indices of
    a block of diagonals are made at once."""
    la = LogAdd(lut, dtype, device)
    B = len(items)
    pairs = [{"x": np.asarray(it["x_sym"], np.int64),
              "y": np.asarray(it["y_sym"], np.int64),
              "rep_x": it.get("rep_x"), "rep_y": it.get("rep_y")}
             for it in items]
    seqs = _Seqs(pairs, device)
    m_tab, gx_tab, gy_tab, tr, rep = _strand_tables(
        tabs, [int(it["strand"]) for it in items], dtype, device)
    if tabs.repeat is None or not seqs.rle:
        rep = None
    lxs = [len(p["x"]) for p in pairs]
    lys = [len(p["y"]) for p in pairs]
    Dmax = max(a + b for a, b in zip(lxs, lys))
    lo = np.zeros((B, Dmax + 3), np.int64)
    hi = np.full((B, Dmax + 3), -1, np.int64)   # empty beyond the item
    for i, it in enumerate(items):
        band = build_band(it.get("anchors"), lxs[i], lys[i], expansion,
                          dynamic)
        lo[i, :len(band)], hi[i, :len(band)] = band[:, 0], band[:, 1]
        lo[i, len(band):] = lo[i, len(band) - 1]
    W = int(((hi - lo) // 2 + 1).max())
    neg = torch.tensor(LOG_ZERO, dtype=dtype, device=device)
    z = torch.zeros((), dtype=dtype, device=device)
    lo_t = torch.tensor(lo, device=device)                      # (B, D+3)
    hi_t = torch.tensor(hi, device=device)
    k = torch.arange(W, device=device)
    lx_t, ly_t = seqs.lx[None, :, None], seqs.ly[None, :, None]
    rl = torch.tensor([bool(it.get("ragged_left")) for it in items],
                      device=device)
    rr = torch.tensor([bool(it.get("ragged_right")) for it in items],
                      device=device)
    end_w = _end_weights(tr, rr)
    D_t = seqs.lx + seqs.ly
    swap = torch.tensor([0, 2, 1], device=device)
    f1, f2, f3 = _trans_stacks(tr, fwd=True)
    b1, b2, b3 = _trans_stacks(tr, fwd=False)

    def block(d0, d1, fwd_sweep):
        """For diagonals d0..d1-1: valid (n, B, 1, W), emissions (n, B,
        3, W) of the cell's own characters (forward) or of those consumed
        leaving it (backward), and the three neighbours' indices (n, B,
        3, W) into their diagonals' rows (W where outside them)."""
        d = torch.arange(d0, d1, device=device)[:, None, None]
        base = lo_t.T[d0:d1][:, :, None]                      # (n, B, 1)
        xmy = base + 2 * k                                    # (n, B, W)
        x, y = (d + xmy) // 2, (d - xmy) // 2
        valid = ((xmy <= hi_t.T[d0:d1][:, :, None]) & (x >= 0) & (y >= 0)
                 & (x <= lx_t) & (y <= ly_t))
        n = d1 - d0
        flat = (lambda a: a.reshape(n * B, W).contiguous())
        if fwd_sweep:
            e = _emissions(m_tab.repeat(n, 1), gx_tab.repeat(n, 1),
                           gy_tab.repeat(n, 1),
                           None if rep is None else rep.repeat(n, 1),
                           _Tiled(seqs, n), flat(x), flat(y))
            steps = ((-2, 0), (-1, -1), (-1, 1))   # (x-1,y-1) (x-1,y) (x,y-1)
        else:
            e = _emissions(m_tab.repeat(n, 1), gx_tab.repeat(n, 1),
                           gy_tab.repeat(n, 1),
                           None if rep is None else rep.repeat(n, 1),
                           _Tiled(seqs, n), flat(x + 1), flat(y + 1))
            steps = ((1, 1), (2, 0), (1, -1))      # gx (x+1,y) m (x+1,y+1)
        emis = torch.stack(e, 1).reshape(n, B, 3, W)          # gy (x,y+1)
        idx = []
        for dd, dxmy in steps:
            src = (d + dd).clamp(0, Dmax + 2)[:, :, 0]        # (n, 1)
            kk = (xmy + dxmy - lo_t.T[src.squeeze(1)][:, :, None]) // 2
            ok = (kk >= 0) & (kk < W)
            idx.append(torch.where(ok, kk, W))
        return valid[:, :, None, :], emis, torch.stack(idx, 2)

    def take(rows, index):
        """rows (B, 3, W+1) at index (B, W), every state."""
        return torch.gather(rows, 2, index[:, None, :].expand(B, 3, W))

    # forward; F[d] rows of W + 1, the last LOG_ZERO
    F = torch.full((Dmax + 1, B, 3, W + 1), LOG_ZERO, dtype=dtype,
                   device=device)
    init = torch.stack([torch.where(rl, neg, z), torch.where(rl, z, neg),
                        torch.where(rl, z, neg)], 1)           # (B, 3)
    F[0, :, :, 0] = init
    empty = torch.full((B, 3, W + 1), LOG_ZERO, dtype=dtype, device=device)
    for d0 in range(1, Dmax + 1, BLOCK):
        d1 = min(d0 + BLOCK, Dmax + 1)
        valid, emis, idx = block(d0, d1, True)
        for j, d in enumerate(range(d0, d1)):
            p2 = F[d - 2] if d >= 2 else empty
            src = torch.stack([take(p2, idx[j, :, 0]),
                               take(F[d - 1], idx[j, :, 1]),
                               take(F[d - 1], idx[j, :, 2]).index_select(
                                   1, swap)], 1)        # (B, tgt, state, W)
            new = emis[j] + la.three(src[:, :, 0] + f1, src[:, :, 1] + f2,
                                     src[:, :, 2] + f3)
            F[d, :, :, :W] = torch.maximum(torch.where(valid[j], new, neg),
                                           neg)
    # totals at each item's final corner (lx, ly): xmy = lx - ly
    bi = torch.arange(B, device=device)
    kf = ((seqs.lx - seqs.ly) - lo_t[bi, D_t]) // 2
    f_end = F[D_t, bi, :, kf.clamp(0, W - 1)]                   # (B, 3)
    totals = la.three(f_end[:, 0] + end_w[:, 0], f_end[:, 1] + end_w[:, 1],
                      f_end[:, 2] + end_w[:, 2])
    # backward, each diagonal's posteriors written over its forward
    end_cell = (k[None, :] == kf[:, None])[:, None, :]           # (B, 1, W)
    nxt1, nxt2 = empty, empty
    for d1 in range(Dmax + 1, 0, -BLOCK):
        d0 = max(d1 - BLOCK, 0)
        valid, emis, idx = block(d0, d1, False)
        for j in range(d1 - d0 - 1, -1, -1):
            d = d0 + j
            to_gx = take(nxt1, idx[j, :, 0])[:, 1] + emis[j, :, 1]
            to_m = take(nxt2, idx[j, :, 1])[:, 0] + emis[j, :, 0]
            to_gy = take(nxt1, idx[j, :, 2])[:, 2] + emis[j, :, 2]
            cur = la.three(to_gx[:, None] + b1, to_m[:, None] + b2,
                           to_gy[:, None] + b3)
            cur = torch.maximum(torch.where(valid[j], cur, neg), neg)
            cur = torch.where((D_t == d)[:, None, None] & end_cell,
                              end_w[:, :, None], cur)
            post = torch.exp(torch.minimum(
                F[d, :, :, :W] + cur - totals[:, None, None], z))
            F[d, :, :, :W] = torch.where(valid[j], post, z)
            nxt2 = nxt1
            nxt1 = torch.cat([cur, empty[:, :, :1]], 2)
    return BandedResult(F[:, :, :, :W], lo_t, totals.double().cpu().numpy(),
                        np.asarray(lxs), np.asarray(lys))


class _Tiled:
    """A batch's sequences seen n times over, for the emissions of a block
    of diagonals laid out (n * B, W)."""

    def __init__(self, seqs: "_Seqs", n: int):
        self.Lx, self.Ly, self.rle = seqs.Lx, seqs.Ly, seqs.rle
        self.x, self.y = seqs.x.repeat(n, 1), seqs.y.repeat(n, 1)
        if seqs.rle:
            self.rx, self.ry = seqs.rx.repeat(n, 1), seqs.ry.repeat(n, 1)

    at = _Seqs.at
