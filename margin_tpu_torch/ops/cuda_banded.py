"""Banded pair-HMM forward-backward over a pack of problems (kernels
K2-fwd and K2-bwd).

Counterpart of `margin_tpu/ops/pallas_banded.py` (the one module of the
port whose name differs from its JAX counterpart's): host prep
`_pack_host` (pallas_banded.py:649-735), the per-diagonal geometry of
`_derive_geom` (:546-575), and `fb_posteriors_group` (:738-825), whose two
Pallas kernels become the CUDA kernels of `csrc/banded_fb.cu`. Parity:
getPosteriorProbsWithBanding (pairwiseAligner.c:706-844).

Layout. A pack holds up to 128 problems, each with its own depth
D_b = lx+ly+1. Per-diagonal arrays (xmy, width, k_lo) are flat and
problem-major: problem b's diagonal d is row geo_off[b] + d. The forward
and posterior grids have the same rows, each (3, W): 3 states by band
storage offset k. W is uniform within a pack (the band-width bucket).

On a CUDA device `fb_forward` / `fb_backward` launch the kernels; on the
CPU they run `fb_forward_plain` / `fb_backward_plain`, the same
recurrences in plain PyTorch vectorised over the pack's problems.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from margin_tpu_torch import _ext
from margin_tpu_torch.ops import logmath
from margin_tpu_torch.ops.pairhmm import (LOG_ZERO, T_EXT_X, T_EXT_Y, T_MM,
                                          T_M_FROM_GX, T_M_FROM_GY, T_OPEN_X,
                                          T_OPEN_Y, T_SW_X, T_SW_Y, _Counter,
                                          _check)
from margin_tpu_torch.params import MAXIMUM_REPEAT_LENGTH

MATCH, GAPX, GAPY = 0, 1, 2
_REP = MAXIMUM_REPEAT_LENGTH

# The port's memory budget for one pack's forward + posterior grids. The
# monolithic kernels run any depth whose grids fit; a pack is split into
# fewer problems to fit, and a single problem beyond it raises (the
# segmented kernels K3 are not ported yet).
FB_GRID_BUDGET_BYTES = 8 << 30


def grid_bytes(n_rows: int, w: int) -> int:
    """Bytes of one pack's forward + posterior grids."""
    return 2 * n_rows * 3 * w * 4


@dataclass
class BandPack:
    """Device-resident inputs of one pack (see the module docstring)."""
    W: int
    lxs: torch.Tensor        # (B,) int32
    lys: torch.Tensor        # (B,) int32
    x_off: torch.Tensor      # (B,) int64 into xs / rep_x
    y_off: torch.Tensor      # (B,) int64 into ys / rep_y
    xs: torch.Tensor         # flat uint8 symbols
    ys: torch.Tensor
    rep_x: Optional[torch.Tensor]  # flat int32 run lengths (RLE only)
    rep_y: Optional[torch.Tensor]
    geo_off: torch.Tensor    # (B,) int64 first row of each problem
    xmy: torch.Tensor        # (rows,) int32 smoothed storage base
    width: torch.Tensor      # (rows,) int32 exclusive upper valid k
    klo: torch.Tensor        # (rows,) int32 first valid k
    k_final: torch.Tensor    # (B,) int32
    tabs: torch.Tensor       # (B, 35) f32: match 25, gapX 5, gapY 5
    trans: torch.Tensor      # (B, 9) f32
    init: torch.Tensor       # (B, 3) f32 start weights
    end_w: torch.Tensor      # (B, 3) f32 end weights
    rep_tab: Optional[torch.Tensor]  # (B, 4*51*51) f32 (RLE only)
    geoms: list              # host BandGeometry per problem

    @property
    def B(self) -> int:
        return int(self.lxs.shape[0])

    @property
    def n_rows(self) -> int:
        return int(self.xmy.shape[0])

    @property
    def device(self) -> torch.device:
        return self.xmy.device


def _pack_host(tables, items, w_pad: int, expansion: int, dynamic: bool,
               use_rle: bool, geoms_in=None, device="cuda") -> BandPack:
    """Pack `items` (dicts with x_sym, y_sym, anchors, strand, optional
    rep_x/rep_y, ragged_left/right) for one launch. geoms_in: optional
    per-item unpadded smoothed BandGeometry from the caller's routing
    pass."""
    from margin_tpu_torch.ops import banded as _banded

    dev = _ext.resolve_device(device)
    B = len(items)
    if not 0 < B <= 128:
        raise ValueError(f"a pack holds 1..128 problems, got {B}")
    lxs = np.array([len(it["x_sym"]) for it in items], np.int64)
    lys = np.array([len(it["y_sym"]) for it in items], np.int64)
    geoms = []
    for i, it in enumerate(items):
        geom = geoms_in[i] if geoms_in is not None else None
        if geom is None:
            geom = _banded.BandGeometry.build(
                it["anchors"], int(lxs[i]), int(lys[i]), expansion,
                dynamic=dynamic, smooth=True)
        if geom.w_pad > w_pad:
            raise ValueError(f"band width {geom.w_pad} > pack width {w_pad}")
        geoms.append(geom)
    d_real = lxs + lys + 1
    geo_off = np.concatenate([[0], np.cumsum(d_real)[:-1]])
    xmy = np.concatenate([g.xmy_l[:n] for g, n in zip(geoms, d_real)])
    width = np.concatenate([g.widths[:n] for g, n in zip(geoms, d_real)])
    klo = np.concatenate([np.zeros(n, np.int32) if g.k_lo is None
                          else g.k_lo[:n] for g, n in zip(geoms, d_real)])
    k_final = np.array([(int(lxs[i]) - int(lys[i])
                         - int(g.xmy_l[lxs[i] + lys[i]])) // 2
                        for i, g in enumerate(geoms)], np.int32)
    if not ((k_final >= 0) & (k_final < w_pad)).all():
        raise ValueError("final band cell outside the pack width")
    x_off = np.concatenate([[0], np.cumsum(lxs)[:-1]])
    y_off = np.concatenate([[0], np.cumsum(lys)[:-1]])

    def cat(key, dtype, clamp=None):
        parts = [np.asarray(it[key]) for it in items]
        flat = (np.concatenate(parts) if sum(len(p) for p in parts)
                else np.zeros(1))
        if clamp is not None:
            flat = np.minimum(flat, clamp)
        return flat.astype(dtype)

    strands = np.array([int(it["strand"]) for it in items], np.int64)
    host = tables.host
    tabs = np.concatenate([host["match"][strands], host["gap_x"][strands],
                           host["gap_y"][strands]], axis=1)
    tr = host["trans"][strands]                               # (B, 9) f32
    neg = np.float32(LOG_ZERO)
    init = np.tile(np.array([0.0, neg, neg], np.float32), (B, 1))
    end_w = np.stack([tr[:, T_MM], tr[:, T_M_FROM_GX], tr[:, T_M_FROM_GY]],
                     axis=1)
    for i, it in enumerate(items):
        if it.get("ragged_left"):
            init[i] = (neg, 0.0, 0.0)
        if it.get("ragged_right"):
            t = tr[i]
            end_w[i] = ((t[T_OPEN_X] + t[T_OPEN_Y]) / 2.0, t[T_EXT_X],
                        t[T_EXT_Y])

    def t(a, dtype=None):
        if a is None:
            return None
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                               device=dev)
    return BandPack(
        W=w_pad, lxs=t(lxs, np.int32), lys=t(lys, np.int32),
        x_off=t(x_off, np.int64), y_off=t(y_off, np.int64),
        xs=t(cat("x_sym", np.uint8)), ys=t(cat("y_sym", np.uint8)),
        rep_x=t(cat("rep_x", np.int32, _REP - 1)) if use_rle else None,
        rep_y=t(cat("rep_y", np.int32, _REP - 1)) if use_rle else None,
        geo_off=t(geo_off, np.int64), xmy=t(xmy, np.int32),
        width=t(width, np.int32), klo=t(klo, np.int32),
        k_final=t(k_final, np.int32), tabs=t(tabs, np.float32),
        trans=t(tr, np.float32), init=t(init, np.float32),
        end_w=t(end_w, np.float32),
        rep_tab=(t(host["repeat"][strands], np.float32) if use_rle
                 else None),
        geoms=geoms)


def derive_geom(pack: BandPack):
    """Per-row (problem, diagonal) index and band bases, as
    `_derive_geom` (pallas_banded.py:556-558) computes them from the xmy
    track. Returns (prob (rows,) int64, diag (rows,) int64, x_base,
    y_base (rows,) int64)."""
    dev = pack.device
    d_real = (pack.lxs.long() + pack.lys.long() + 1)
    prob = torch.repeat_interleave(torch.arange(pack.B, device=dev), d_real)
    diag = torch.arange(pack.n_rows, device=dev) - pack.geo_off[prob]
    xmy = pack.xmy.long()
    xb = torch.div(diag + xmy, 2, rounding_mode="floor") - 1
    yb = torch.div(diag - xmy, 2, rounding_mode="floor") - 1
    return prob, diag, xb, yb


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

FB_FORWARD = _Counter()
FB_BACKWARD = _Counter()


@functools.lru_cache(maxsize=None)
def _k2():
    lib = _ext.kernel_lib("banded_fb")
    for name in ("k2_forward", "k2_backward"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
    return lib


def _validate(pack: BandPack):
    dev = pack.device
    B, W, rows = pack.B, pack.W, pack.n_rows
    if W not in (16, 32, 64, 128):
        raise ValueError(f"K2 takes W in (16, 32, 64, 128), got {W}")
    if not 0 < B <= 128:
        raise ValueError(f"K2 takes 1..128 problems, got {B}")
    for name, dtype, shape in (
            ("lxs", torch.int32, (B,)), ("lys", torch.int32, (B,)),
            ("x_off", torch.int64, (B,)), ("y_off", torch.int64, (B,)),
            ("geo_off", torch.int64, (B,)), ("k_final", torch.int32, (B,)),
            ("xmy", torch.int32, (rows,)), ("width", torch.int32, (rows,)),
            ("klo", torch.int32, (rows,)), ("tabs", torch.float32, (B, 35)),
            ("trans", torch.float32, (B, 9)), ("init", torch.float32, (B, 3)),
            ("end_w", torch.float32, (B, 3))):
        _check(getattr(pack, name), name, dtype, shape, dev)
    _check(pack.xs, "xs", torch.uint8, tuple(pack.xs.shape), dev)
    _check(pack.ys, "ys", torch.uint8, tuple(pack.ys.shape), dev)
    if pack.rep_x is not None:
        _check(pack.rep_x, "rep_x", torch.int32, tuple(pack.xs.shape), dev)
        _check(pack.rep_y, "rep_y", torch.int32, tuple(pack.ys.shape), dev)
        _check(pack.rep_tab, "rep_tab", torch.float32, (B, 4 * _REP * _REP),
               dev)


def _args(pack: BandPack, fwd, totals, post):
    ptrs = [pack.xs, pack.ys, pack.rep_x, pack.rep_y, pack.x_off, pack.y_off,
            pack.lxs, pack.lys, pack.geo_off, pack.xmy, pack.width, pack.klo,
            pack.k_final, pack.tabs, pack.trans, pack.init, pack.end_w,
            pack.rep_tab, fwd, totals, post]
    return (ctypes.c_void_p * len(ptrs))(
        *[None if p is None else p.data_ptr() for p in ptrs])


def fb_forward(pack: BandPack, use_lut: bool):
    """Banded forward of a pack: returns (fwd (rows, 3, W) f32, totals (B,)
    f32). A pack on a CUDA device launches K2-fwd; on the CPU the plain
    twin runs."""
    if pack.device.type != "cuda":
        return fb_forward_plain(pack, use_lut)
    _validate(pack)
    if grid_bytes(pack.n_rows, pack.W) > FB_GRID_BUDGET_BYTES:
        raise NotImplementedError(
            "pack grids exceed FB_GRID_BUDGET_BYTES; deeper problems need "
            "the segmented kernels K3 (ROADMAP queue 1, slice 2)")
    dev = pack.device
    fwd = torch.empty((pack.n_rows, 3, pack.W), dtype=torch.float32,
                      device=dev)
    totals = torch.empty(pack.B, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _k2().k2_forward(_args(pack, fwd, totals, None), pack.B, pack.W,
                          int(bool(use_lut)), stream)
    _ext.check_launch(rc, "banded forward (K2-fwd)")
    FB_FORWARD.launches += 1
    return fwd, totals


def fb_backward(pack: BandPack, fwd: torch.Tensor, totals: torch.Tensor,
                use_lut: bool) -> torch.Tensor:
    """Backward + posterior of a pack: returns post (rows, 3, W) f32,
    zero outside the band. CUDA: K2-bwd; CPU: the plain twin."""
    if pack.device.type != "cuda":
        return fb_backward_plain(pack, fwd, totals, use_lut)
    _validate(pack)
    dev = pack.device
    _check(fwd, "fwd", torch.float32, (pack.n_rows, 3, pack.W), dev)
    _check(totals, "totals", torch.float32, (pack.B,), dev)
    post = torch.empty_like(fwd)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _k2().k2_backward(_args(pack, fwd, totals, post), pack.B, pack.W,
                           int(bool(use_lut)), stream)
    _ext.check_launch(rc, "banded backward (K2-bwd)")
    FB_BACKWARD.launches += 1
    return post


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

class _Padded:
    """Per-problem (B, Dmax+2) views of a pack's flat per-diagonal arrays,
    and the emissions of every cell of both sweeps, for the plain twins."""

    def __init__(self, pack: BandPack, sweep: str):
        dev = pack.device
        self.B, self.W = pack.B, pack.W
        self.lx = pack.lxs.long()
        self.ly = pack.lys.long()
        self.D = self.lx + self.ly                     # final diagonal
        self.Dmax = int(self.D.max()) + 1
        d_idx = torch.arange(self.Dmax + 2, device=dev)[None, :]
        in_real = d_idx <= self.D[:, None]              # (B, Dmax+2)
        self.rows = torch.where(in_real, pack.geo_off[:, None] + d_idx, 0)

        def per_diag(a):
            return torch.where(in_real, a.long()[self.rows], 0)
        self.xmy = per_diag(pack.xmy)
        self.k = torch.arange(self.W, device=dev)[None, :]          # (1, W)
        # band mask and emissions of every grid row, gathered per diagonal
        prob, diag, xb, yb = derive_geom(pack)
        k = self.k
        x_pos = xb[:, None] + 1 + k
        y_pos = yb[:, None] + 1 - k
        self.vm = ((k >= pack.klo.long()[:, None])
                   & (k < pack.width.long()[:, None])
                   & (x_pos >= 0) & (x_pos <= self.lx[prob][:, None])
                   & (y_pos >= 0) & (y_pos <= self.ly[prob][:, None]))
        if sweep == "fwd":   # the cell's own characters
            ix, iy = x_pos - 1, y_pos - 1
        else:                # the characters of (x+1, y+1)
            ix, iy = x_pos, y_pos
        self.e_m, self.e_gx, self.e_gy = _emissions(pack, prob, ix, iy)

    def at(self, g: int):
        """(rows of diagonal g, band mask (B, 1, W), e_m, e_gx, e_gy)."""
        r = self.rows[:, g]
        vm = self.vm[r] & (g <= self.D)[:, None]
        return r, vm[:, None, :], self.e_m[r], self.e_gx[r], self.e_gy[r]


def _emissions(pack: BandPack, prob, ix, iy):
    """Emission values of cells consuming x index ix and y index iy
    ((rows, W) each); out-of-range positions read symbol 4 with run length
    0, as the Pallas windows' fill does (pallas_banded.py:606-610)."""
    lx = pack.lxs.long()[prob][:, None]
    ly = pack.lys.long()[prob][:, None]
    inx = (ix >= 0) & (ix < lx)
    iny = (iy >= 0) & (iy < ly)
    fx = torch.where(inx, pack.x_off[prob][:, None] + ix, 0)
    fy = torch.where(iny, pack.y_off[prob][:, None] + iy, 0)
    sx = torch.where(inx, pack.xs.long()[fx], 4)
    sy = torch.where(iny, pack.ys.long()[fy], 4)
    tabs = pack.tabs.reshape(-1)
    t0 = prob[:, None] * 35
    e_m = tabs[t0 + sx * 5 + sy]
    e_gx = tabs[t0 + 25 + sx]
    e_gy = tabs[t0 + 30 + sy]
    if pack.rep_x is not None:
        rx = torch.where(inx, pack.rep_x.long()[fx], 0)
        ry = torch.where(iny, pack.rep_y.long()[fy], 0)
        base = torch.where(sx >= 4, 0, sx)  # N -> A (repeatSubMatrix.c:16-27)
        rep = pack.rep_tab.reshape(-1)
        e_m = e_m + rep[prob[:, None] * (4 * _REP * _REP)
                        + base * (_REP * _REP) + rx * _REP + ry]
    return e_m, e_gx, e_gy


def _padded(arr: torch.Tensor) -> torch.Tensor:
    """(B, ..., W) -> (B, ..., W+2) with LOG_ZERO on both ends."""
    pad = torch.full(arr.shape[:-1] + (1,), LOG_ZERO, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([pad, arr, pad], dim=-1)


def _shift(padded: torch.Tensor, sel: torch.Tensor, W: int):
    """Read a _padded (B, ..., W+2) array at k + sel[b] for k in [0, W):
    LOG_ZERO beyond the band storage."""
    idx = (torch.arange(W, device=padded.device)[None, :] + sel[:, None]
           + 1).clamp(0, W + 1)
    idx = idx.view((idx.shape[0],) + (1,) * (padded.dim() - 2) + (W,))
    return torch.gather(padded, -1, idx.expand(padded.shape[:-1] + (W,)))


def fb_forward_plain(pack: BandPack, use_lut: bool):
    """Plain PyTorch twin of K2-fwd (the Pallas `_fwd_kernel` recurrence,
    pallas_banded.py:206-247), vectorised over the pack's problems."""
    la = logmath.log_add_fn(use_lut)
    P = _Padded(pack, "fwd")
    dev = pack.device
    B, W = P.B, P.W
    neg = torch.tensor(LOG_ZERO, dtype=torch.float32, device=dev)
    tr = [pack.trans[:, i:i + 1] for i in range(9)]
    fwd = torch.empty((pack.n_rows, 3, W), dtype=torch.float32, device=dev)
    # diagonal 0: start weights at k = 0 (stateMachine.c:521-530)
    cur = torch.where(P.k[:, None, :] == 0, pack.init[:, :, None], neg)
    cur = cur.expand(B, 3, W).contiguous()
    fwd[pack.geo_off] = cur
    prev1 = _padded(cur)
    prev2 = _padded(torch.full((B, 3, W), LOG_ZERO, dtype=torch.float32,
                               device=dev))

    def la3(a, b, c):
        return la(la(a, b), c)

    for g in range(1, P.Dmax):
        xm = P.xmy[:, g]
        s1 = torch.div(xm - 1 - P.xmy[:, g - 1], 2, rounding_mode="floor")
        s2 = (torch.div(xm - P.xmy[:, g - 2], 2, rounding_mode="floor")
              if g >= 2 else torch.zeros_like(xm))
        low = _shift(prev1, s1, W)        # (x-1, y)
        up = _shift(prev1, s1 + 1, W)     # (x, y-1)
        mid = _shift(prev2, s2, W)        # (x-1, y-1)
        rows, vm, e_m, e_gx, e_gy = P.at(g)
        new_gx = e_gx + la3(low[:, MATCH] + tr[T_OPEN_X],
                            low[:, GAPX] + tr[T_EXT_X],
                            low[:, GAPY] + tr[T_SW_X])
        new_m = e_m + la3(mid[:, MATCH] + tr[T_MM],
                          mid[:, GAPX] + tr[T_M_FROM_GX],
                          mid[:, GAPY] + tr[T_M_FROM_GY])
        new_gy = e_gy + la3(up[:, MATCH] + tr[T_OPEN_Y],
                            up[:, GAPY] + tr[T_EXT_Y],
                            up[:, GAPX] + tr[T_SW_Y])
        cur = torch.stack([new_m, new_gx, new_gy], dim=1)       # (B, 3, W)
        cur = torch.maximum(torch.where(vm, cur, neg), neg)
        live = g <= P.D
        fwd[rows[live]] = cur[live]
        prev2 = prev1
        prev1 = _padded(cur)
    # total at the final corner with the end weights (:401-411)
    last = fwd[pack.geo_off + P.D]                               # (B, 3, W)
    f3 = torch.gather(last, 2, pack.k_final.long()[:, None, None]
                      .expand(B, 3, 1))[:, :, 0]
    t = f3 + pack.end_w
    totals = la(la(t[:, 0], t[:, 1]), t[:, 2])
    return fwd, totals


def fb_backward_plain(pack: BandPack, fwd: torch.Tensor,
                      totals: torch.Tensor, use_lut: bool) -> torch.Tensor:
    """Plain PyTorch twin of K2-bwd (the Pallas `_bwd_kernel` recurrence,
    pallas_banded.py:294-340)."""
    la = logmath.log_add_fn(use_lut)
    P = _Padded(pack, "bwd")
    dev = pack.device
    B, W = P.B, P.W
    neg = torch.tensor(LOG_ZERO, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tr = [pack.trans[:, i:i + 1] for i in range(9)]
    post = torch.zeros_like(fwd)
    next1 = _padded(torch.full((B, 3, W), LOG_ZERO, dtype=torch.float32,
                               device=dev))
    next2 = next1
    kf = pack.k_final.long()[:, None]
    bwd_final = torch.where((P.k == kf)[:, None, :], pack.end_w[:, :, None],
                            neg)                                  # (B, 3, W)
    total = totals[:, None, None]

    def la3(a, b, c):
        return la(la(a, b), c)

    for g in range(P.Dmax - 1, -1, -1):
        xm = P.xmy[:, g]
        t1 = torch.div(xm + 1 - P.xmy[:, g + 1], 2, rounding_mode="floor")
        t2 = torch.div(xm - P.xmy[:, g + 2], 2, rounding_mode="floor")
        gx_n = _shift(next1[:, GAPX], t1, W)       # (x+1, y)
        gy_n = _shift(next1[:, GAPY], t1 - 1, W)   # (x, y+1)
        m_n = _shift(next2[:, MATCH], t2, W)       # (x+1, y+1)
        rows, vm, e_m, e_gx, e_gy = P.at(g)
        b_m = la3(gx_n + e_gx + tr[T_OPEN_X], m_n + e_m + tr[T_MM],
                  gy_n + e_gy + tr[T_OPEN_Y])
        b_gx = la3(gx_n + e_gx + tr[T_EXT_X], m_n + e_m + tr[T_M_FROM_GX],
                   gy_n + e_gy + tr[T_SW_Y])
        b_gy = la3(gx_n + e_gx + tr[T_SW_X], m_n + e_m + tr[T_M_FROM_GY],
                   gy_n + e_gy + tr[T_EXT_Y])
        computed = torch.maximum(
            torch.where(vm, torch.stack([b_m, b_gx, b_gy], dim=1), neg), neg)
        at_final = (P.D == g)[:, None, None]
        cur = torch.where(at_final, bwd_final, computed)
        live = g <= P.D
        r = rows[live]
        p = torch.exp(torch.minimum(fwd[r] + cur[live] - total[live], zero))
        post[r] = torch.where(vm[live], p, zero)
        next2 = next1
        next1 = _padded(cur)
    return post


def fb_posteriors_group(tables, items, w_pad: int, expansion: int,
                        use_lut: bool, dynamic: bool, use_rle: bool,
                        geoms_in=None, device="cuda"):
    """Solve one pack (<= 128 problems of band width <= w_pad) with the
    banded forward-backward. Returns (post (rows, 3, W), totals (B,),
    pack), all on `device`. Optional per-item "ragged_left" /
    "ragged_right" flags select the ragged start/end state weights
    (stateMachine.c:521-560)."""
    pack = _pack_host(tables, items, w_pad, expansion, dynamic, use_rle,
                      geoms_in, device)
    fwd, totals = fb_forward(pack, use_lut)
    post = fb_backward(pack, fwd, totals, use_lut)
    return post, totals, pack

