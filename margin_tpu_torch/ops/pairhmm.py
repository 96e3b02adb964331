"""Batched 3-state pair-HMM total forward probability (kernel K1).

Counterpart of `margin_tpu/ops/pairhmm.py`. The reference scores one
(read substring, allele) pair at a time (computeForwardProbability,
pairwiseAligner.c:849-903) with an empty anchor list, so its band covers
the whole rectangle and the dense anti-diagonal recurrence is exactly the
reference computation.

`forward_total` sends a batch on a CUDA device to the hand-written kernel
`csrc/pairhmm_forward.cu` (a lane per anti-diagonal row, a block per
pair; `k1_launch` mirrors its launch configuration) and a batch
on the CPU to `forward_total_plain`, the same recurrence in plain PyTorch
with the JAX function's operation order (`_forward_total`,
pairhmm.py:194-346).

States: 0=match, 1=gapX (consumes x), 2=gapY (consumes y)
(stateMachine.c:10-12); transitions/emissions per StateMachine3
(stateMachine.c:562-586); start/end weights stateMachine.c:521-560.
Run-length-encoded emissions (stateMachine.c:716-752): with repeat tables
the match emission gains 2.3025 * repeat[slot(x base), rep_x, rep_y].
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
from margin_tpu_torch.params import (MAXIMUM_REPEAT_LENGTH, RepeatSubMatrix,
                                     StateMachineParams)

MATCH, GAPX, GAPY = 0, 1, 2
LOG_ZERO = -1.0e30  # finite stand-in for -inf: keeps the arithmetic NaN-free

# transition vector layout (StateMachineParams.transition_vector)
(T_MM, T_M_FROM_GX, T_M_FROM_GY, T_OPEN_X, T_OPEN_Y, T_EXT_X, T_EXT_Y,
 T_SW_X, T_SW_Y) = range(9)


@dataclass(frozen=True)
class PairHmmTables:
    """Emission/transition tables on one device, strand-stacked.

    match:  (2, 25) flattened 5x5 log match emissions per strand
    gap_x:  (2, 5)
    gap_y:  (2, 5)
    trans:  (2, 9)  transition log-probs (layout above)
    repeat: (2, 4*51*51) optional RLE match-emission addend, flattened
            [slot_base, underlying(rep_x), observed(rep_y)], already scaled
            by the 2.3025 natural-log factor.
    """
    match: torch.Tensor
    gap_x: torch.Tensor
    gap_y: torch.Tensor
    trans: torch.Tensor
    repeat: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.match.device

    @functools.cached_property
    def host(self) -> dict:
        """float32 numpy copies, for the host engines."""
        out = {k: getattr(self, k).cpu().numpy()
               for k in ("match", "gap_x", "gap_y", "trans")}
        out["repeat"] = (None if self.repeat is None
                         else self.repeat.cpu().numpy())
        return out

    @staticmethod
    def from_params(sm_fwd: StateMachineParams,
                    sm_rev: Optional[StateMachineParams] = None,
                    repeat: Optional[RepeatSubMatrix] = None,
                    device="cuda") -> "PairHmmTables":
        """Same numpy construction as the JAX package's
        `PairHmmTables.from_params` (pairhmm.py:66-97)."""
        if sm_rev is None:
            sm_rev = sm_fwd.reverse_complement()

        def clamp(a):
            return np.maximum(np.nan_to_num(np.asarray(a, np.float64),
                                            neginf=LOG_ZERO), LOG_ZERO)
        match = np.stack([clamp(sm_fwd.match_probs).ravel(),
                          clamp(sm_rev.match_probs).ravel()])
        gx = np.stack([clamp(sm_fwd.gap_x_probs), clamp(sm_rev.gap_x_probs)])
        gy = np.stack([clamp(sm_fwd.gap_y_probs), clamp(sm_rev.gap_y_probs)])
        tr = np.stack([clamp(sm_fwd.transition_vector()),
                       clamp(sm_rev.transition_vector())])
        rep = None
        if repeat is not None:
            n = MAXIMUM_REPEAT_LENGTH
            # slot for (base b, strand s): s ? b : 3-b (repeatSubMatrix.c:28-31)
            fwd = repeat.log_probs.reshape(4, n * n)
            rev = repeat.log_probs[::-1].reshape(4, n * n)
            rep = np.asarray(2.3025 * np.stack([fwd, rev]).reshape(2, 4 * n * n),
                             dtype=np.float32)
        return tables_from_numpy(match, gx, gy, tr, rep, device=device)


def tables_from_numpy(match, gap_x, gap_y, trans, repeat=None,
                      device="cuda") -> PairHmmTables:
    """Carry numpy tables (for instance the JAX package's, its "weights")
    into the port as float32 tensors on `device`."""
    dev = _ext.resolve_device(device)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                               device=dev)
    return PairHmmTables(t(match), t(gap_x), t(gap_y), t(trans),
                         None if repeat is None else t(repeat))


def tables_like(src, device="cuda") -> PairHmmTables:
    """Carry tables built elsewhere into the port: any object with match,
    gap_x, gap_y, trans and repeat arrays in the layout above, such as the
    JAX package's PairHmmTables.from_params(pp.sm_forward, pp.sm_reverse,
    repeat=pp.repeat_sub_matrix) for a polish params file."""
    rep = getattr(src, "repeat", None)
    return tables_from_numpy(*(np.asarray(getattr(src, k)) for k in
                               ("match", "gap_x", "gap_y", "trans")),
                             None if rep is None else np.asarray(rep),
                             device=device)


@dataclass(frozen=True)
class PairBatch:
    """A padded batch of (x, y) sequence pairs, on one device.

    xs, ys:   (B, Lx), (B, Ly) uint8 symbol codes (0..4), padded with 4.
    lxs, lys: (B,) int32 true lengths.
    strands:  (B,) int32: 0 selects the forward-strand tables, 1 reverse.
    ragged_left/right: (B,) bool start/end boundary conditions.
    rep_x/rep_y: optional (B, L) int32 run lengths (clamped to 50) for RLE.
    """
    xs: torch.Tensor
    ys: torch.Tensor
    lxs: torch.Tensor
    lys: torch.Tensor
    strands: torch.Tensor
    ragged_left: torch.Tensor
    ragged_right: torch.Tensor
    rep_x: Optional[torch.Tensor] = None
    rep_y: Optional[torch.Tensor] = None


def _pack_rows(seqs, width: int, fill: int, dtype, clamp=None) -> np.ndarray:
    """Left-aligned rows of `seqs` in a (len(seqs), width) array."""
    out = np.full((len(seqs), width), fill, dtype=dtype)
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    if lens.sum():
        flat = np.concatenate([np.asarray(s) for s in seqs])
        if clamp is not None:
            flat = np.minimum(flat, clamp)
        rows = np.repeat(np.arange(len(seqs)), lens)
        cols = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
        out[rows, cols] = flat
    return out


def make_batch(seq_pairs, strands=None, ragged_left=None, ragged_right=None,
               rep_pairs=None, device="cuda", pad_to=None) -> PairBatch:
    """Host-side batch packing. seq_pairs: list of (x_sym, y_sym) numpy
    arrays; pad_to: optional minimum (Lx, Ly). The kernel takes any shape,
    so there is no shape bucketing."""
    dev = _ext.resolve_device(device)
    b = len(seq_pairs)
    xs_l = [p[0] for p in seq_pairs]
    ys_l = [p[1] for p in seq_pairs]
    lx = max((len(x) for x in xs_l), default=1)
    ly = max((len(y) for y in ys_l), default=1)
    if pad_to is not None:
        lx, ly = max(lx, pad_to[0]), max(ly, pad_to[1])
    lx, ly = max(lx, 1), max(ly, 1)
    xs = _pack_rows(xs_l, lx, 4, np.uint8)
    ys = _pack_rows(ys_l, ly, 4, np.uint8)
    lxs = np.fromiter((len(x) for x in xs_l), np.int32, b)
    lys = np.fromiter((len(y) for y in ys_l), np.int32, b)
    rx = ry = None
    if rep_pairs is not None:
        cap = MAXIMUM_REPEAT_LENGTH - 1
        rx = _pack_rows([r[0] for r in rep_pairs], lx, 0, np.int32, cap)
        ry = _pack_rows([r[1] for r in rep_pairs], ly, 0, np.int32, cap)

    def vec(v, dtype):
        out = np.zeros(b, dtype=dtype)
        if v is not None:
            out[:] = np.asarray(v, dtype=dtype)
        return out

    def t(a):
        return None if a is None else torch.as_tensor(a, device=dev)
    return PairBatch(t(xs), t(ys), t(lxs), t(lys), t(vec(strands, np.int32)),
                     t(vec(ragged_left, bool)), t(vec(ragged_right, bool)),
                     t(rx), t(ry))


# ---------------------------------------------------------------------------
# kernel K1 wrapper
# ---------------------------------------------------------------------------

# Launch configuration of K1 (csrc/pairhmm_forward.cu checks it,
# config_ok, and lays out its shared memory, block_bytes). A block holds a
# pair: ceil((Ly + 1) / (32 R)) warps, a lane R consecutive rows of an
# anti-diagonal, R in {1, 2, 4, 8} the fewest rows a lane that keep the
# block at <= 1024 threads. Its shared memory holds the 44 table floats,
# then, when they fit (stage_x), the x symbols and (RLE) x run lengths as
# bytes, each in round_up(Lx + 4, 16) bytes, then the exchange's two slots
# of warps x 3 floats. A longer X is read from device memory.
MAX_LY = 8191


@dataclass(frozen=True)
class K1Launch:
    """warps: of the block; rows: R, rows a lane holds; stage_x: X staged
    in shared memory (else read from device memory); smem: shared-memory
    bytes of the block."""
    warps: int
    rows: int
    stage_x: bool
    smem: int


def k1_launch(Lx: int, Ly: int, rle: bool) -> K1Launch:
    """K1's launch configuration for a batch padded to (Lx, Ly). Raises
    ValueError for Ly > MAX_LY."""
    if Ly > MAX_LY:
        raise ValueError(f"K1 takes Ly <= {MAX_LY} (a block holds 1024 "
                         f"lanes of at most 8 rows), got {Ly}")
    w = Ly + 1
    rows = next(r for r in (1, 2, 4, 8) if w <= 1024 * r)
    warps = -(-w // (32 * rows))
    fixed = 44 * 4 + 2 * warps * 3 * 4
    staged = fixed + (2 if rle else 1) * (-(-(Lx + 4) // 16) * 16)
    if staged <= _ext.MAX_SMEM:
        return K1Launch(warps, rows, True, staged)
    return K1Launch(warps, rows, False, fixed)


class _Counter:
    """Plain launch counter of one kernel wrapper."""

    def __init__(self):
        self.launches = 0


FORWARD_TOTAL = _Counter()

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _k1_lib():
    lib = _ext.kernel_lib("pairhmm_forward")
    lib.k1_forward_total.restype = ctypes.c_int
    lib.k1_forward_total.argtypes = [_P] * 15 + [ctypes.c_int] * 8 + [_P]
    lib.k1_smem_bytes.restype = ctypes.c_int
    lib.k1_smem_bytes.argtypes = [ctypes.c_int] * 4
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def forward_total(tables: PairHmmTables, batch: PairBatch,
                  use_lut: bool = False) -> torch.Tensor:
    """(B,) float32 total forward log-probabilities. A batch on a CUDA
    device launches kernel K1 on the current stream; a batch on the CPU
    runs `forward_total_plain`."""
    dev = batch.xs.device
    if dev.type != "cuda":
        return forward_total_plain(tables, batch, use_lut=use_lut)
    B, Lx = batch.xs.shape
    Ly = batch.ys.shape[1]
    use_rle = tables.repeat is not None and batch.rep_x is not None
    _check(batch.xs, "xs", torch.uint8, (B, Lx), dev)
    _check(batch.ys, "ys", torch.uint8, (B, Ly), dev)
    for name in ("lxs", "lys", "strands"):
        _check(getattr(batch, name), name, torch.int32, (B,), dev)
    for name in ("ragged_left", "ragged_right"):
        _check(getattr(batch, name), name, torch.bool, (B,), dev)
    for name, shape in (("match", (2, 25)), ("gap_x", (2, 5)),
                        ("gap_y", (2, 5)), ("trans", (2, 9))):
        _check(getattr(tables, name), name, torch.float32, shape, dev)
    if use_rle:
        _check(batch.rep_x, "rep_x", torch.int32, (B, Lx), dev)
        _check(batch.rep_y, "rep_y", torch.int32, (B, Ly), dev)
        n = MAXIMUM_REPEAT_LENGTH
        _check(tables.repeat, "repeat", torch.float32, (2, 4 * n * n), dev)
    launch = k1_launch(Lx, Ly, use_rle)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _k1_lib().k1_forward_total(
        _ptr(batch.xs), _ptr(batch.ys), _ptr(batch.lxs), _ptr(batch.lys),
        _ptr(batch.strands), _ptr(batch.ragged_left),
        _ptr(batch.ragged_right), _ptr(batch.rep_x) if use_rle else None,
        _ptr(batch.rep_y) if use_rle else None, _ptr(tables.match),
        _ptr(tables.gap_x), _ptr(tables.gap_y), _ptr(tables.trans),
        _ptr(tables.repeat) if use_rle else None, _ptr(out), B, Lx, Ly,
        int(bool(use_lut)), launch.warps, launch.rows, int(launch.stage_x),
        launch.smem, stream)
    _ext.check_launch(rc, "pairhmm forward (K1)")
    FORWARD_TOTAL.launches += 1
    return out


def forward_total_plain(tables: PairHmmTables, batch: PairBatch,
                        use_lut: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of K1: the JAX `_forward_total` recurrence with
    its operation order. Layout: the diagonal slab is (W, B), row y holding
    cell (x = d - y, y).
      gapX(x,y)  <- diag d-1 at row y      (cell (x-1, y))
      gapY(x,y)  <- diag d-1 at row y-1    (cell (x, y-1))
      match(x,y) <- diag d-2 at row y-1    (cell (x-1, y-1))
    The emission selects of the JAX kernel pick exactly one table entry
    per cell, so they are written here as gathers (same values)."""
    log_add = logmath.log_add_fn(use_lut)
    dev = batch.xs.device
    B, Lx = batch.xs.shape
    Ly = batch.ys.shape[1]
    W = Ly + 1
    D = Lx + Ly
    f32 = torch.float32
    neg = torch.tensor(LOG_ZERO, dtype=f32, device=dev)
    use_rle = tables.repeat is not None and batch.rep_x is not None
    strands = batch.strands.long()
    m_tab = tables.match[strands]            # (B, 25)
    gx_tab = tables.gap_x[strands]           # (B, 5)
    gy_tab = tables.gap_y[strands]
    tr = tables.trans[strands]               # (B, 9)
    trc = [tr[:, i] for i in range(9)]       # (B,)

    y_iota = torch.arange(W, device=dev, dtype=torch.int64)[:, None]  # (W,1)
    lys_r = batch.lys.long()[None, :]
    lxs_r = batch.lxs.long()[None, :]
    # y-symbol per row: row y holds Y[y-1]; row 0 -> N (4)
    cy = torch.cat([torch.full((B, 1), 4, dtype=torch.int64, device=dev),
                    batch.ys.long()], dim=1).T                      # (W, B)
    e_gy = torch.gather(gy_tab.T, 0, cy)                            # (W, B)
    # x symbol at row y of diagonal d is X[d-1-y]; with
    # xpad = [N*Ly, reverse(X), N*W] that is xpad[Lx+Ly-d+y]
    xpad = torch.cat([torch.full((B, Ly), 4, dtype=torch.int64, device=dev),
                      torch.flip(batch.xs.long(), [1]),
                      torch.full((B, W), 4, dtype=torch.int64, device=dev)],
                     dim=1).T                                       # (L, B)
    if use_rle:
        n = MAXIMUM_REPEAT_LENGTH
        ry = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                        batch.rep_y.long()], dim=1).T               # (W, B)
        rxpad = torch.cat([
            torch.zeros((B, Ly), dtype=torch.int64, device=dev),
            torch.flip(batch.rep_x.long(), [1]),
            torch.zeros((B, W), dtype=torch.int64, device=dev)], dim=1).T
        rep_tab = tables.repeat[strands].T                          # (R, B)

    rl = batch.ragged_left[None, :]
    row0 = y_iota == 0
    m0 = torch.where(row0 & ~rl, torch.zeros((), dtype=f32, device=dev), neg)
    g0 = torch.where(row0 & rl, torch.zeros((), dtype=f32, device=dev), neg)
    p1 = (m0, g0, g0)                       # (match, gapX, gapY), (W, B)
    negdiag = torch.full((W, B), LOG_ZERO, dtype=f32, device=dev)
    p2 = (negdiag, negdiag, negdiag)
    neg_row = torch.full((1, B), LOG_ZERO, dtype=f32, device=dev)
    result = torch.full((B,), LOG_ZERO, dtype=f32, device=dev)

    def shift_row(a):  # row y <- row y-1 (prepend a LOG_ZERO row)
        return torch.cat([neg_row, a[:-1]], dim=0)

    def log_add3(a, b, c):
        return log_add(log_add(a, b), c)

    rr = batch.ragged_right
    end_m = torch.where(rr, (trc[T_OPEN_X] + trc[T_OPEN_Y]) / 2.0, trc[T_MM])
    end_x = torch.where(rr, trc[T_EXT_X], trc[T_M_FROM_GX])
    end_y = torch.where(rr, trc[T_EXT_Y], trc[T_M_FROM_GY])
    d_final = batch.lxs.long() + batch.lys.long()
    final_row = y_iota == lys_r                                     # (W, B)

    for d in range(1, D + 1):
        cx = xpad[Lx + Ly - d:Lx + Ly - d + W]                      # (W, B)
        e_m = torch.gather(m_tab.T, 0, cx * 5 + cy)
        e_gx = torch.gather(gx_tab.T, 0, cx)
        if use_rle:
            rxw = rxpad[Lx + Ly - d:Lx + Ly - d + W]
            base = torch.where(cx >= 4, 0, cx)  # N -> A (repeatSubMatrix.c:16-27)
            e_m = e_m + torch.gather(rep_tab, 0, base * (n * n) + rxw * n + ry)
        p1m, p1x, p1y = p1
        p2m, p2x, p2y = p2
        s2m, s2x, s2y = shift_row(p2m), shift_row(p2x), shift_row(p2y)
        u1m, u1x, u1y = shift_row(p1m), shift_row(p1x), shift_row(p1y)
        # the three states' 3-way logAdds in one call (m, gx, gy): each
        # element sees the JAX function's operations in its order
        new = torch.stack([e_m, e_gx, e_gy]) + log_add3(
            torch.stack([s2m + trc[T_MM], p1m + trc[T_OPEN_X],
                         u1m + trc[T_OPEN_Y]]),
            torch.stack([s2x + trc[T_M_FROM_GX], p1x + trc[T_EXT_X],
                         u1y + trc[T_EXT_Y]]),
            torch.stack([s2y + trc[T_M_FROM_GY], p1y + trc[T_SW_X],
                         u1x + trc[T_SW_Y]]))
        x_pos = d - y_iota
        valid = (y_iota <= lys_r) & (x_pos >= 0) & (x_pos <= lxs_r)
        # clamp accumulated underflow to the finite LOG_ZERO
        new_m, new_gx, new_gy = torch.maximum(torch.where(valid, new, neg),
                                              neg)
        hit = d_final == d
        if bool(hit.any()):
            # the total at d == lx+ly, row y == ly (pairwiseAligner.c:882-892)
            fm = torch.where(final_row, new_m, neg).amax(0)
            fx = torch.where(final_row, new_gx, neg).amax(0)
            fy = torch.where(final_row, new_gy, neg).amax(0)
            tot = log_add(log_add(fm + end_m, fx + end_x), fy + end_y)
            result = torch.where(hit, tot, result)
        p2 = p1
        p1 = (new_m, new_gx, new_gy)
    # lx+ly == 0 returns LOG_ONE (pairwiseAligner.c:860-862)
    return torch.where(d_final == 0, torch.zeros((), dtype=f32, device=dev),
                       result)
