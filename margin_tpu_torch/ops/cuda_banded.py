"""Banded pair-HMM forward-backward over a pack of problems: the
monolithic kernels K2-fwd / K2-bwd (with K2-bwd's WORDS instance, which
emits the extraction words), the transition expectations K4, the
wide-band forward and expectations K5-fwd / K5-exp and the segmented
kernels K3-fwd / K3-bwd.

Counterpart of `margin_tpu/ops/pallas_banded.py` (the one module of the
port whose name differs from its JAX counterpart's): host prep
`_pack_host` (pallas_banded.py:649-735), the per-diagonal geometry of
`_derive_geom` (:546-575), and `fb_posteriors_group` (:738-825), whose two
Pallas kernels become the CUDA kernels of `csrc/banded_fb.cu`, and
`fb_posteriors_group_seg` (:1346-1397), whose segmented Pallas kernels
become those of `csrc/banded_seg.cu`; the XLA extraction of
`margin_tpu/ops/banded.py:_device_extract_flat` (:704-756), which becomes
K2-bwd's WORDS instance (`fb_backward_words`, `fb_posteriors_words`: no
posterior grid); and the expectations pass of the XLA scan
`margin_tpu/ops/banded.py:_banded_fb_core` (:267, compute_expectations
:478-486), which becomes K4: K2-bwd's walk with each band cell's nine
transition expectations summed in place of its stored posteriors
(`fb_expectations`), and, for bands wider than 128 cells, K5
(`fb_forward_wide`, `fb_expectations_wide`: K2's kernels at 6-16 warps
for bands of 136-512 cells, `csrc/banded_wide.cu`'s strided kernels for
wider ones). Parity: getPosteriorProbsWithBanding (pairwiseAligner.c:706-844).

Layout. A pack holds up to 128 problems, each with its own depth
D_b = lx+ly+1. Per-diagonal arrays (xmy, width, k_lo) are flat and
problem-major: problem b's diagonal d is row geo_off[b] + d. The forward
and posterior grids have the same rows, each (3, W): 3 states by band
storage offset k. W is uniform within a pack (the band-width bucket).

The segmented kernels keep no grid: the forward stores the carry (the two
previous diagonals) at the start of every segment of S diagonals, and the
backward recomputes each segment's forward from its carry, runs the
backward through it and compacts the posterior cells above the threshold
into the extraction words of `banded.extract_packed`. Checkpoints are
(segments, 2, 3, W), problem b's segments from `seg_layout(pack, S)[0][b]`.

On a CUDA device `fb_forward` / `fb_backward` / `fb_backward_words` /
`fb_expectations` / `fb_forward_wide` / `fb_expectations_wide` /
`seg_forward` / `seg_backward` launch the kernels; on the CPU they run the
`*_plain` twins, the same recurrences in plain PyTorch vectorised over the
pack's problems (the segmented twins walk the same segments). K2 and K3
walk a problem in chunks of diagonals staged in a block's shared memory,
so the chunk depth is a property of the launch (`K2_CHUNK`,
`K2_WORDS_CHUNK`, `SEG_D`) and `k2_smem` / `k3_smem` mirror the blocks'
layouts.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from margin_tpu_torch import _ext
from margin_tpu_torch._ext import MAX_SMEM
from margin_tpu_torch.ops import logmath
from margin_tpu_torch.ops.pairhmm import (LOG_ZERO, T_EXT_X, T_EXT_Y, T_MM,
                                          T_M_FROM_GX, T_M_FROM_GY, T_OPEN_X,
                                          T_OPEN_Y, T_SW_X, T_SW_Y, _Counter,
                                          _check)
from margin_tpu_torch.params import MAXIMUM_REPEAT_LENGTH

MATCH, GAPX, GAPY = 0, 1, 2
_REP = MAXIMUM_REPEAT_LENGTH
_FLAT_PAD = 16

# The port's memory budget for one pack's forward + posterior grids. The
# monolithic kernels run any pack whose grids fit; a problem whose own
# grids do not fit takes the segmented kernels.
FB_GRID_BUDGET_BYTES = 8 << 30

# Launch configuration of the kernels. A K2 or K3 block holds, in shared
# memory, the problem's tables and two staging buffers of a chunk of
# diagonals' inputs (csrc/banded_step.cuh:layout): K2 stages the chunk's
# forward rows there (K2-fwd writes them, K2-bwd reads them), and K3-bwd
# keeps its recomputed (S, 3, W) segment besides. The chunk depth is
# therefore a property of the launch, bounded by the 227 KB a Hopper block
# may use (232,448 bytes, set per kernel with cudaFuncSetAttribute). The
# JAX package's `_seg_d` (pallas_banded.py:863-870) sized a device-memory
# scratch instead.
SEG_STEP = 16
_WORDS = 1024      # extraction words staged per block (WORDS_PER_BLOCK)
_XCH_NW = 4        # warps the exchange slots hold at least (XCH_MIN_NW)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def block_warps(w: int) -> int:
    """Warps of a K2 or K3 block at width w (csrc/banded_step.cuh:
    block_warps): one a 32 band cells, lanes k >= w idle, rounded up to an
    even count above 128 cells (6, 8, .., 16 for K5's step design)."""
    return (max(1, _round_up(w, 32) // 32) if w <= 128
            else _round_up(w, 64) // 32)


def _block_bytes(w: int, depth: int, rle: bool, rows: int, tail: int) -> int:
    """csrc/banded_step.cuh:layout, in bytes: a block walking chunks of
    `depth` diagonals whose staging buffers carry `rows` bytes of float
    rows each and whose own tail is `tail` bytes."""
    stage = (_round_up(12 * (depth + 4), 16) + 2 * _round_up(depth + w + 8, 16)
             + (8 * _round_up(depth + w + 4, 4) if rle else 0) + rows)
    return ((4 * _REP * _REP * 4 if rle else 0) + 36 * 4 + 2 * stage + tail
            + 48 * max(block_warps(w), _XCH_NW))


def _k3_smem_bytes(w: int, seg_d: int, rle: bool, sweep: str) -> int:
    """The layout of csrc/banded_seg.cu:k3_layout, in bytes."""
    bwd = sweep == "bwd"
    return _block_bytes(w, seg_d, rle, 24 * w if bwd else 0,
                        12 * seg_d * w + 8 * _WORDS if bwd else 0)


def _k2_smem_bytes(w: int, chunk: int, rle: bool, words: bool = False) -> int:
    """The layout of csrc/banded_fb.cu:k2_layout, in bytes."""
    return _block_bytes(w, chunk, rle, 12 * chunk * w,
                        8 * _WORDS if words else 0)


def k2_smem(w: int, chunk: int, rle: bool, words: bool = False) -> int:
    """Shared-memory bytes of one K2 block, K2-fwd's or K2-bwd's (one
    layout), at width w and chunk depth `chunk`: the problem's repeat
    table (RLE) and emissions, and two staging buffers of a chunk's
    geometry, symbol and run-length windows and forward rows (K2-fwd
    writes them, K2-bwd reads them); K2-bwd's WORDS instance (words=True)
    also its staged words. Raises ValueError for a chunk the block cannot
    hold."""
    if chunk < 1:
        raise ValueError(f"chunk depth must be >= 1, got {chunk}")
    n = _k2_smem_bytes(w, chunk, rle, words)
    if n > MAX_SMEM:
        raise ValueError(f"K2 block of {n} bytes at W={w}, C={chunk}, RLE "
                         f"{'on' if rle else 'off'} exceeds the {MAX_SMEM} "
                         "bytes of shared memory a block may use")
    return n


@functools.lru_cache(maxsize=None)
def k2_chunk(w: int, rle: bool, words: bool = False) -> int:
    """The deepest chunk whose K2 block (words: K2-bwd WORDS's) fits at
    width w."""
    c = 1
    while _k2_smem_bytes(w, c + 1, rle, words) <= MAX_SMEM:
        c += 1
    return c


# Chunk depth of K2-fwd and K2-bwd per (band-width bucket, RLE): what a
# K2 block holds (443 / 233 / 119 / 60 diagonals at W = 16 / 32 / 64 /
# 128 with RLE on, a few more without its repeat table); K2_WORDS_CHUNK
# the same for K2-bwd's WORDS instance, whose block also stages words.
K2_CHUNK = {(w, rle): k2_chunk(w, rle) for w in (16, 32, 64, 128)
            for rle in (True, False)}
K2_WORDS_CHUNK = {(w, rle): k2_chunk(w, rle, True) for w in (16, 32, 64, 128)
                  for rle in (True, False)}


def k3_smem(w: int, seg_d: int, rle: bool, sweep: str) -> int:
    """Shared-memory bytes of one K3 block ("fwd" or "bwd") at width w and
    segment depth seg_d: the problem's repeat table (RLE) and emissions,
    two staging buffers of a segment's geometry, symbol and run-length
    windows (and, K3-bwd, its checkpoint), and, K3-bwd, the recomputed
    segment and the staged words. Raises ValueError for a segment the
    block cannot hold."""
    if seg_d < 2:
        raise ValueError(f"segment depth must be >= 2, got {seg_d}")
    n = _k3_smem_bytes(w, seg_d, rle, sweep)
    if n > MAX_SMEM:
        raise ValueError(f"K3 block of {n} bytes at W={w}, S={seg_d}, RLE "
                         f"{'on' if rle else 'off'} exceeds the "
                         f"{MAX_SMEM} bytes of shared memory a block may "
                         "use")
    return n


def seg_depth(w: int, rle: bool = True) -> int:
    """The largest multiple of SEG_STEP whose K3-bwd block fits at width
    w."""
    s = SEG_STEP
    while _k3_smem_bytes(w, s + SEG_STEP, rle, "bwd") <= MAX_SMEM:
        s += SEG_STEP
    return s


# Segment depth per band-width bucket: what a K3-bwd block with RLE on
# holds (the checkpoints grow in number, ~1.4 MB per 45k-diagonal problem
# at W = 128).
SEG_D = {w: seg_depth(w) for w in (16, 32, 64, 128)}


# K5, a band wider than 128 cells, has two designs. "step": K2's kernels
# (csrc/banded_k2.cuh) at NW = block_warps(W) = 6, 8, .., 16 warps, lane
# k holding cell k, for W <= K5_STEP_MAX_W; "strided"
# (csrc/banded_wide.cu): a block whose threads stride over the band with
# a ring of three diagonals in shared memory (device memory beyond ~6400
# cells), for any wider band. The wrappers pick the design from W before
# the launch.
K5_DESIGNS = ("step", "strided")
K5_STEP_MAX_W = 512


def k5_design(w: int) -> str:
    """The design a K5 launch on a pack of width w takes: "step" for a
    width of 136..K5_STEP_MAX_W that is a multiple of 8 (the packs'
    widths), else "strided"."""
    return ("step" if 128 < w <= K5_STEP_MAX_W and w % 8 == 0
            else "strided")


def _k5_smem_bytes(w: int, ring_shared: bool) -> int:
    """The layout of csrc/banded_wide.cu:k5_layout, in bytes: the
    emissions, the block reduction's 32 x 9 sums and (ring_shared) the
    ring of three diagonals, 3 x 3 x (w + 2) floats."""
    return 36 * 4 + 32 * 9 * 4 + (36 * (w + 2) if ring_shared else 0)


def k5_ring_shared(w: int) -> bool:
    """Whether a strided K5 block keeps its ring of diagonals in shared
    memory (up to ~6400 cells); wider bands keep it in device memory."""
    return _k5_smem_bytes(w, True) <= MAX_SMEM


def k5_threads(w: int) -> int:
    """Threads of a strided K5 block: one a cell up to 1024 cells, which
    stride over wider bands."""
    return min(1024, _round_up(w, 32))


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
        # the flat arrays end in _FLAT_PAD spare entries: K3 stages symbol
        # windows by whole 4-byte words
        parts = [np.asarray(it[key]) for it in items]
        flat = np.concatenate(parts + [np.zeros(_FLAT_PAD)])
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
# every launch of K2-bwd's backward + posterior walk, POST or WORDS
# instance; FB_WORDS counts the WORDS instance's alone
FB_BACKWARD = _Counter()
FB_WORDS = _Counter()
FB_EXPECT = _Counter()
SEG_FORWARD = _Counter()
SEG_BACKWARD = _Counter()


class _WideCounter(_Counter):
    """K5's launch counter: every launch, and the launches of each design
    (K5_DESIGNS)."""

    def __init__(self):
        super().__init__()
        self.designs = dict.fromkeys(K5_DESIGNS, 0)

    def reset(self):
        with self._lock:
            self.launches = 0
            self.designs = dict.fromkeys(K5_DESIGNS, 0)

    def add(self, design: str):
        with self._lock:
            self.launches += 1
            self.designs[design] += 1


FB_FORWARD_WIDE = _WideCounter()
FB_EXPECT_WIDE = _WideCounter()


@functools.lru_cache(maxsize=None)
def _k2():
    lib = _ext.kernel_lib("banded_fb")
    for name in ("k2_forward", "k2_backward", "k2_expectations"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
    lib.k2_backward_words.restype = ctypes.c_int
    lib.k2_backward_words.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for name in ("k2_smem_bytes", "k2_words_smem_bytes"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_int] * 3
    return lib


@functools.lru_cache(maxsize=None)
def _k3():
    lib = _ext.kernel_lib("banded_seg")
    lib.k3_forward.restype = ctypes.c_int
    lib.k3_forward.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.k3_backward.restype = ctypes.c_int
    lib.k3_backward.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.k3_smem_bytes.restype = ctypes.c_int
    lib.k3_smem_bytes.argtypes = [ctypes.c_int] * 4
    return lib


@functools.lru_cache(maxsize=None)
def _k5():
    lib = _ext.kernel_lib("banded_wide")
    for name in ("k5_forward", "k5_expectations"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
    for name in ("k5_step_forward", "k5_step_expectations"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
    lib.k5_smem_bytes.restype = ctypes.c_int
    lib.k5_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.k5_step_smem_bytes.restype = ctypes.c_int
    lib.k5_step_smem_bytes.argtypes = [ctypes.c_int] * 3
    return lib


def _validate(pack: BandPack, wide: bool = False):
    """Check a pack's tensors against the kernels' layout: K2 and K3 take
    the widths (16, 32, 64, 128), K5 (wide) any."""
    dev = pack.device
    B, W, rows = pack.B, pack.W, pack.n_rows
    if not wide and W not in (16, 32, 64, 128):
        raise ValueError(f"K2 takes W in (16, 32, 64, 128), got {W}")
    if W < 1:
        raise ValueError(f"band width must be >= 1, got {W}")
    if not 0 < B <= 128:
        raise ValueError(f"a pack holds 1..128 problems, got {B}")
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


def _validate_windows(pack: BandPack):
    """K2 and K3 stage symbol windows by whole 4-byte words: the flat
    symbol arrays need 4 spare entries past the last sequence (_pack_host
    pads them). Checked on the host geometries, without a device sync."""
    if (pack.xs.numel() < sum(g.lx for g in pack.geoms) + 4
            or pack.ys.numel() < sum(g.ly for g in pack.geoms) + 4):
        raise ValueError("K2 and K3 read the flat symbols by 4-byte words: "
                         "they need 4 spare entries at the end (_pack_host "
                         "pads them)")


def _k2_launch(pack: BandPack, chunk: Optional[int], words: bool = False):
    """(chunk, shared-memory bytes) of a K2 launch on a pack: chunk
    defaults to K2_CHUNK (words: K2_WORDS_CHUNK) of the pack's width and
    RLE state; k2_smem raises for a chunk the block cannot hold."""
    _validate(pack)
    _validate_windows(pack)
    rle = pack.rep_x is not None
    if chunk is None:
        chunk = (K2_WORDS_CHUNK if words else K2_CHUNK)[(pack.W, rle)]
    return chunk, k2_smem(pack.W, chunk, rle, words)


def _args(pack: BandPack, *extra):
    """The 18 pack pointers of csrc/banded_cell.cuh:BandArgs, then the
    kernel's own buffers."""
    ptrs = [pack.xs, pack.ys, pack.rep_x, pack.rep_y, pack.x_off, pack.y_off,
            pack.lxs, pack.lys, pack.geo_off, pack.xmy, pack.width, pack.klo,
            pack.k_final, pack.tabs, pack.trans, pack.init, pack.end_w,
            pack.rep_tab, *extra]
    return (ctypes.c_void_p * len(ptrs))(
        *[None if p is None else p.data_ptr() for p in ptrs])


def fb_forward(pack: BandPack, use_lut: bool, chunk: Optional[int] = None):
    """Banded forward of a pack: returns (fwd (rows, 3, W) f32, totals (B,)
    f32). A pack on a CUDA device launches K2-fwd, walking chunks of
    `chunk` diagonals (default K2_CHUNK; the results do not depend on it);
    on the CPU the plain twin runs."""
    if pack.device.type != "cuda":
        return fb_forward_plain(pack, use_lut)
    chunk, smem = _k2_launch(pack, chunk)
    if grid_bytes(pack.n_rows, pack.W) > FB_GRID_BUDGET_BYTES:
        raise ValueError("pack grids exceed FB_GRID_BUDGET_BYTES; deep "
                         "problems take the segmented kernels (seg_forward)")
    dev = pack.device
    fwd = torch.empty((pack.n_rows, 3, pack.W), dtype=torch.float32,
                      device=dev)
    totals = torch.empty(pack.B, dtype=torch.float32, device=dev)
    rc = _ext.launch(dev, _k2().k2_forward, _args(pack, fwd, totals),
                     pack.B, pack.W, chunk, int(bool(use_lut)), smem)
    _ext.check_launch(rc, "banded forward (K2-fwd)")
    FB_FORWARD.add()
    return fwd, totals


def fb_backward(pack: BandPack, fwd: torch.Tensor, totals: torch.Tensor,
                use_lut: bool, chunk: Optional[int] = None) -> torch.Tensor:
    """Backward + posterior of a pack: returns post (rows, 3, W) f32,
    zero outside the band. CUDA: K2-bwd, which stages each chunk's forward
    rows in shared memory (chunk as in fb_forward); CPU: the plain
    twin."""
    if pack.device.type != "cuda":
        return fb_backward_plain(pack, fwd, totals, use_lut)
    chunk, smem = _k2_launch(pack, chunk)
    dev = pack.device
    _check(fwd, "fwd", torch.float32, (pack.n_rows, 3, pack.W), dev)
    _check(totals, "totals", torch.float32, (pack.B,), dev)
    post = torch.empty_like(fwd)
    rc = _ext.launch(dev, _k2().k2_backward, _args(pack, fwd, totals, post),
                     pack.B, pack.W, chunk, int(bool(use_lut)), smem)
    _ext.check_launch(rc, "banded backward (K2-bwd)")
    FB_BACKWARD.add()
    return post


def _check_word_budget(pack: BandPack):
    """The extraction words hold k < 128 and 3b+s < 511, which a pack of
    W <= 128 and B <= 128 keeps (_validate), and d < 2^22: checked from
    the problems' depths on the host, before a launch (the ValueError of
    banded.extract_packed)."""
    if max(g.lx + g.ly for g in pack.geoms) >= 1 << 22:
        raise ValueError("pairs exceed the extraction word's bit budget")


def fb_backward_words(pack: BandPack, fwd: torch.Tensor,
                      totals: torch.Tensor, use_lut: bool, threshold: float,
                      cap: Optional[int] = None,
                      chunk: Optional[int] = None):
    """Backward + posterior + extraction of a pack: returns (lo, hi) int32
    extraction words (banded.extract_packed's), in no particular order; no
    posterior grid is made. CUDA: K2-bwd's WORDS instance (chunk as in
    fb_forward, default K2_WORDS_CHUNK), launched again with the exact
    capacity when the first guess `cap` (K3-bwd's, 2 x rows + 16384)
    overflows; CPU: fb_words_plain."""
    if pack.device.type != "cuda":
        return fb_words_plain(pack, fwd, totals, use_lut, threshold)
    chunk, smem = _k2_launch(pack, chunk, words=True)
    _check_word_budget(pack)
    dev = pack.device
    _check(fwd, "fwd", torch.float32, (pack.n_rows, 3, pack.W), dev)
    _check(totals, "totals", torch.float32, (pack.B,), dev)
    if cap is None:
        cap = 2 * pack.n_rows + 16384
    while True:
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        lo = torch.empty(cap, dtype=torch.int32, device=dev)
        hi = torch.empty(cap, dtype=torch.int32, device=dev)
        rc = _ext.launch(
            dev, _k2().k2_backward_words,
            _args(pack, fwd, totals, count, lo, hi), pack.B, pack.W, chunk,
            int(bool(use_lut)), smem, float(threshold), cap)
        _ext.check_launch(rc, "banded backward and extraction (K2-bwd "
                              "WORDS)")
        FB_BACKWARD.add()
        FB_WORDS.add()
        n = int(count.item())
        if n <= cap:
            return lo[:n], hi[:n]
        cap = n


def fb_expectations(pack: BandPack, fwd: torch.Tensor, totals: torch.Tensor,
                    use_lut: bool, chunk: Optional[int] = None
                    ) -> torch.Tensor:
    """Baum-Welch transition expectations of a pack: returns (B, 3, 3) f32
    [from, to] expected transition counts, states (match, gapX, gapY).
    CUDA: K4, K2-bwd's walk summing each band cell's expectations in
    place of storing its posteriors (chunk as in fb_forward); CPU: the
    plain twin."""
    if pack.device.type != "cuda":
        return fb_expectations_plain(pack, fwd, totals, use_lut)
    chunk, smem = _k2_launch(pack, chunk)
    dev = pack.device
    _check(fwd, "fwd", torch.float32, (pack.n_rows, 3, pack.W), dev)
    _check(totals, "totals", torch.float32, (pack.B,), dev)
    out = torch.empty((pack.B, 3, 3), dtype=torch.float32, device=dev)
    rc = _ext.launch(dev, _k2().k2_expectations,
                     _args(pack, fwd, totals, out), pack.B, pack.W, chunk,
                     int(bool(use_lut)), smem)
    _ext.check_launch(rc, "banded transition expectations (K4)")
    FB_EXPECT.add()
    return out


def _k5_design(pack: BandPack, design: Optional[str]) -> str:
    """The design of a K5 launch on a pack: k5_design(W) unless the checks
    force one ("strided" serves any width, "step" those k5_design gives
    it)."""
    _validate(pack, wide=True)
    if design is None:
        design = k5_design(pack.W)
    if design not in K5_DESIGNS:
        raise ValueError(f"K5 design {design!r} not in {K5_DESIGNS}")
    if design == "step" and k5_design(pack.W) != "step":
        raise ValueError(f"K5's step design takes W in 136..{K5_STEP_MAX_W}"
                         f", a multiple of 8; got {pack.W}")
    return design


def _k5_step_launch(pack: BandPack):
    """(chunk, shared-memory bytes) of a K5 launch on K2's step: the
    deepest chunk the block holds (k2_chunk)."""
    _validate_windows(pack)
    rle = pack.rep_x is not None
    chunk = k2_chunk(pack.W, rle)
    return chunk, k2_smem(pack.W, chunk, rle)


def _k5_strided_launch(pack: BandPack, ring_shared: Optional[bool]):
    """(threads, shared-memory bytes, ring_shared, device ring or None) of
    a strided K5 launch on a pack; ring_shared defaults to
    k5_ring_shared(W) (False forces the device-memory ring)."""
    W = pack.W
    if ring_shared is None:
        ring_shared = k5_ring_shared(W)
    smem = _k5_smem_bytes(W, ring_shared)
    if smem > MAX_SMEM:
        raise ValueError(f"K5 block of {smem} bytes at W={W} exceeds the "
                         f"{MAX_SMEM} bytes of shared memory a block may use")
    ring = None if ring_shared else torch.empty(
        pack.B * 9 * (W + 2), dtype=torch.float32, device=pack.device)
    return k5_threads(W), smem, ring_shared, ring


def _k5_forward_step(pack, use_lut, fwd, totals):
    chunk, smem = _k5_step_launch(pack)
    return _ext.launch(pack.device, _k5().k5_step_forward,
                       _args(pack, fwd, totals), pack.B, pack.W, chunk,
                       int(bool(use_lut)), smem)


def _k5_forward_strided(pack, use_lut, fwd, totals, ring_shared):
    threads, smem, ring_shared, ring = _k5_strided_launch(pack, ring_shared)
    return _ext.launch(pack.device, _k5().k5_forward,
                       _args(pack, fwd, totals, ring), pack.B, pack.W,
                       threads, int(bool(use_lut)), smem, int(ring_shared))


def _k5_expect_step(pack, use_lut, fwd, totals, out):
    chunk, smem = _k5_step_launch(pack)
    return _ext.launch(pack.device, _k5().k5_step_expectations,
                       _args(pack, fwd, totals, out), pack.B, pack.W, chunk,
                       int(bool(use_lut)), smem)


def _k5_expect_strided(pack, use_lut, fwd, totals, out, ring_shared):
    threads, smem, ring_shared, ring = _k5_strided_launch(pack, ring_shared)
    return _ext.launch(pack.device, _k5().k5_expectations,
                       _args(pack, fwd, totals, out, ring), pack.B, pack.W,
                       threads, int(bool(use_lut)), smem, int(ring_shared))


# K5's launchers by design: each fills the wrapper's outputs and returns
# the C launch's error code; the strided ones also take ring_shared
K5_FORWARD = {"step": _k5_forward_step, "strided": _k5_forward_strided}
K5_EXPECT = {"step": _k5_expect_step, "strided": _k5_expect_strided}


def _on_card(pack: BandPack) -> bool:
    """Whether a pack's tensors lie on a CUDA device (K5's wrappers launch
    a kernel there, and run the plain twin on the CPU)."""
    return pack.device.type == "cuda"


def fb_forward_wide(pack: BandPack, use_lut: bool,
                    ring_shared: Optional[bool] = None,
                    design: Optional[str] = None):
    """Banded forward of a pack of any band width: (fwd (rows, 3, W) f32,
    totals (B,) f32), fb_forward's results. CUDA: K5-fwd, in the design
    k5_design(W) gives: K2-fwd's kernel at block_warps(W) warps for a width
    of 136..K5_STEP_MAX_W (walking chunks of the deepest its block holds),
    else the strided kernel (the last three
    diagonals in shared memory or, ring_shared False, in device memory);
    `design` forces one, for the checks. CPU: the plain twin."""
    if not _on_card(pack):
        return fb_forward_plain(pack, use_lut)
    design = _k5_design(pack, design)
    if grid_bytes(pack.n_rows, pack.W) > FB_GRID_BUDGET_BYTES:
        raise ValueError("pack grids exceed FB_GRID_BUDGET_BYTES")
    fwd = torch.empty((pack.n_rows, 3, pack.W), dtype=torch.float32,
                      device=pack.device)
    totals = torch.empty(pack.B, dtype=torch.float32, device=pack.device)
    launch = K5_FORWARD[design]
    rc = (launch(pack, use_lut, fwd, totals) if design == "step"
          else launch(pack, use_lut, fwd, totals, ring_shared))
    _ext.check_launch(rc, f"wide banded forward (K5-fwd, {design})")
    FB_FORWARD_WIDE.add(design)
    return fwd, totals


def fb_expectations_wide(pack: BandPack, fwd: torch.Tensor,
                         totals: torch.Tensor, use_lut: bool,
                         ring_shared: Optional[bool] = None,
                         design: Optional[str] = None) -> torch.Tensor:
    """Transition expectations of a pack of any band width: (B, 3, 3) f32
    [from, to], fb_expectations' results. CUDA: K5-exp, in the design of
    fb_forward_wide: K4's kernel (K2-bwd's walk summing each band cell's
    nine expectations) at block_warps(W) warps, or the strided kernel's
    backward walk; CPU: the plain twin."""
    if not _on_card(pack):
        return fb_expectations_plain(pack, fwd, totals, use_lut)
    design = _k5_design(pack, design)
    dev = pack.device
    _check(fwd, "fwd", torch.float32, (pack.n_rows, 3, pack.W), dev)
    _check(totals, "totals", torch.float32, (pack.B,), dev)
    out = torch.empty((pack.B, 3, 3), dtype=torch.float32, device=dev)
    launch = K5_EXPECT[design]
    rc = (launch(pack, use_lut, fwd, totals, out) if design == "step"
          else launch(pack, use_lut, fwd, totals, out, ring_shared))
    _ext.check_launch(rc, "wide banded transition expectations (K5-exp, "
                          f"{design})")
    FB_EXPECT_WIDE.add(design)
    return out


def seg_layout(pack: BandPack, seg_d: int):
    """Checkpoint layout of the segmented kernels: (seg_off (B,) int64
    first segment of each problem, total segments). Problem b has
    (lx+ly) // seg_d + 1 segments, covering its diagonals 0..lx+ly."""
    n_seg = torch.div(pack.lxs.long() + pack.lys.long(), seg_d,
                      rounding_mode="floor") + 1
    seg_off = torch.cumsum(n_seg, 0) - n_seg
    return seg_off.contiguous(), int(n_seg.sum())


def _validate_seg(pack: BandPack, seg_d: int):
    _validate(pack)
    _validate_windows(pack)
    if seg_d < 2:
        raise ValueError(f"segment depth must be >= 2, got {seg_d}")
    d_max = max(g.lx + g.ly for g in pack.geoms)
    if d_max >= 1 << 22:
        raise ValueError(f"diagonal {d_max} beyond the extraction word's "
                         "22-bit budget")


def seg_forward(pack: BandPack, use_lut: bool, seg_d: int):
    """Checkpointing forward of a pack: returns (ckpt (segments, 2, 3, W)
    f32, the carry into each segment; totals (B,) f32). CUDA: K3-fwd,
    raising for a segment depth K3-bwd's block cannot hold (k3_smem), as
    no backward could consume its checkpoints; CPU: the plain twin."""
    if pack.device.type != "cuda":
        return seg_forward_plain(pack, use_lut, seg_d)
    _validate_seg(pack, seg_d)
    rle = pack.rep_x is not None
    k3_smem(pack.W, seg_d, rle, "bwd")
    smem = k3_smem(pack.W, seg_d, rle, "fwd")
    dev = pack.device
    seg_off, n_total = seg_layout(pack, seg_d)
    ckpt = torch.empty((n_total, 2, 3, pack.W), dtype=torch.float32,
                       device=dev)
    totals = torch.empty(pack.B, dtype=torch.float32, device=dev)
    rc = _ext.launch(dev, _k3().k3_forward,
                     _args(pack, seg_off, ckpt, totals), pack.B, pack.W,
                     seg_d, int(bool(use_lut)), smem)
    _ext.check_launch(rc, "segmented banded forward (K3-fwd)")
    SEG_FORWARD.add()
    return ckpt, totals


def seg_backward(pack: BandPack, ckpt: torch.Tensor, totals: torch.Tensor,
                 use_lut: bool, seg_d: int, threshold: float,
                 cap: Optional[int] = None):
    """Recompute + backward + posterior + extraction of a pack from its
    checkpoints: returns (lo, hi) int32 extraction words (see
    banded.extract_packed), in no particular order. CUDA: K3-bwd, which
    keeps the recomputed segment in shared memory (raising for a segment
    depth its block cannot hold, k3_smem), launched again with the exact
    capacity when the first guess `cap` overflows; CPU: the plain twin."""
    if pack.device.type != "cuda":
        return seg_backward_plain(pack, ckpt, totals, use_lut, seg_d,
                                  threshold)
    _validate_seg(pack, seg_d)
    smem = k3_smem(pack.W, seg_d, pack.rep_x is not None, "bwd")
    dev = pack.device
    seg_off, n_total = seg_layout(pack, seg_d)
    _check(ckpt, "ckpt", torch.float32, (n_total, 2, 3, pack.W), dev)
    _check(totals, "totals", torch.float32, (pack.B,), dev)
    if cap is None:
        cap = 2 * pack.n_rows + 16384
    while True:
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        lo = torch.empty(cap, dtype=torch.int32, device=dev)
        hi = torch.empty(cap, dtype=torch.int32, device=dev)
        rc = _ext.launch(
            dev, _k3().k3_backward,
            _args(pack, seg_off, ckpt, totals, count, lo, hi),
            pack.B, pack.W, seg_d, int(bool(use_lut)), smem,
            float(threshold), cap)
        _ext.check_launch(rc, "segmented banded backward (K3-bwd)")
        SEG_BACKWARD.add()
        n = int(count.item())
        if n <= cap:
            return lo[:n], hi[:n]
        cap = n


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

class _Padded:
    """Per-problem (B, Dmax+2) views of a pack's flat per-diagonal arrays,
    the shift selectors of every diagonal, and the emissions of every cell
    of one sweep, for the plain twins. Row `n_rows` is a blank row (outside
    every band) that diagonals beyond a problem's depth read."""

    def __init__(self, pack: BandPack, sweep: str):
        dev = pack.device
        self.B, self.W = pack.B, pack.W
        self.lx = pack.lxs.long()
        self.ly = pack.lys.long()
        self.D = self.lx + self.ly                     # final diagonal
        self.Dmax = int(self.D.max()) + 1
        d_idx = torch.arange(self.Dmax + 2, device=dev)[None, :]
        in_real = d_idx <= self.D[:, None]              # (B, Dmax+2)
        self.rows = torch.where(in_real, pack.geo_off[:, None] + d_idx,
                                pack.n_rows)
        self.xmy = torch.where(in_real, torch.cat(
            [pack.xmy.long(), pack.xmy.new_zeros(1).long()])[self.rows], 0)
        self.k = torch.arange(self.W, device=dev)[None, :]          # (1, W)
        self.k1 = self.k + 1   # storage offset past a _padded array's pad
        # band mask and emissions of every grid row (and the blank row)
        prob, diag, xb, yb = derive_geom(pack)
        k = self.k
        x_pos = xb[:, None] + 1 + k
        y_pos = yb[:, None] + 1 - k
        vm = ((k >= pack.klo.long()[:, None])
              & (k < pack.width.long()[:, None])
              & (x_pos >= 0) & (x_pos <= self.lx[prob][:, None])
              & (y_pos >= 0) & (y_pos <= self.ly[prob][:, None]))
        self.vm = torch.cat([vm, vm.new_zeros((1, self.W))])
        xm, z1 = self.xmy, torch.zeros_like(self.xmy[:, :1])

        def half(a):
            return torch.div(a, 2, rounding_mode="floor")
        if sweep == "fwd":   # the cell's own characters
            e_m, e_gx, e_gy = _emissions(pack, prob, x_pos - 1, y_pos - 1)
            e = torch.stack([e_m, e_gx, e_gy], dim=1)
            # the shifts of (x-1, y-1), (x-1, y), (x, y-1) into the
            # previous two diagonals, per diagonal g >= 1
            s1 = half(xm - 1 - torch.cat([z1, xm[:, :-1]], 1))
            s2 = half(xm - torch.cat([z1, z1, xm[:, :-2]], 1))
            s2[:, :2] = 0
            self.sel = torch.stack([s2, s1, s1 + 1], dim=2)
        else:                # the characters of (x+1, y+1)
            e_m, e_gx, e_gy = _emissions(pack, prob, x_pos, y_pos)
            e = torch.stack([e_gx, e_m, e_gy], dim=1)
            # the shifts of (x+1, y), (x+1, y+1), (x, y+1) into the next
            # two diagonals, per diagonal g
            t1 = half(xm + 1 - torch.cat([xm[:, 1:], z1], 1))
            t2 = half(xm - torch.cat([xm[:, 2:], z1, z1], 1))
            self.sel = torch.stack([t1, t2, t1 - 1], dim=2)
        self.e = torch.cat([e, e.new_zeros((1, 3, self.W))])

    def at(self, g: int):
        """(rows of diagonal g, band mask (B, 1, W), emissions (B, 3, W):
        state-major (m, gx, gy) in the forward, (gx, m, gy) in the
        backward)."""
        r = self.rows[:, g]
        return r, self.vm[r][:, None, :], self.e[r]

    def shift(self, src: torch.Tensor, g: int):
        """Read the _padded sources src (B, 3, ..., W+2) at k + sel[b, g, i]
        for k in [0, W): LOG_ZERO beyond the band storage."""
        W = self.W
        idx = (self.k1 + self.sel[:, g, :, None]).clamp_(0, W + 1)
        idx = idx.view(idx.shape[:2] + (1,) * (src.dim() - 3) + (W,))
        return torch.gather(src, -1, idx.expand(src.shape[:-1] + (W,)))


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
    return torch.nn.functional.pad(arr, (1, 1), value=LOG_ZERO)


_UP_STATES = (MATCH, GAPY, GAPX)   # the (x, y-1) cell's terms, state-major


class _Sweep:
    """What one plain sweep needs besides the carry: the padded views and
    emissions (_Padded), the transitions of every term, the logAdd flavour
    and the LOG_ZERO constant."""

    def __init__(self, pack: BandPack, sweep: str, use_lut: bool):
        self.P = _Padded(pack, sweep)
        self.la = logmath.log_add_fn(use_lut)
        tr = pack.trans
        if sweep == "fwd":
            # (B, target state, term, 1): the terms of the 3-way logAdd of
            # each state, in the Pallas kernel's order
            idx = ((T_MM, T_M_FROM_GX, T_M_FROM_GY),
                   (T_OPEN_X, T_EXT_X, T_SW_X),
                   (T_OPEN_Y, T_EXT_Y, T_SW_Y))
        else:
            # (B, term, source state, 1): each term's transition out of
            # each state, the terms (x+1, y), (x+1, y+1), (x, y+1)
            idx = ((T_OPEN_X, T_EXT_X, T_SW_X),
                   (T_MM, T_M_FROM_GX, T_M_FROM_GY),
                   (T_OPEN_Y, T_SW_Y, T_EXT_Y))
        self.tr = tr[:, torch.tensor(idx, device=pack.device)][..., None]
        self.up = torch.tensor(_UP_STATES, device=pack.device)
        self.neg = torch.tensor(LOG_ZERO, dtype=torch.float32,
                                device=pack.device)

    def la3(self, a, b, c):
        return self.la(self.la(a, b), c)

    def empty(self):
        """(B, 3, W) of LOG_ZERO."""
        return torch.full((self.P.B, 3, self.P.W), LOG_ZERO,
                          dtype=torch.float32, device=self.neg.device)


def _init_diag(pack: BandPack, sw: _Sweep) -> torch.Tensor:
    """Diagonal 0: start weights at k = 0 (stateMachine.c:521-530)."""
    cur = torch.where(sw.P.k[:, None, :] == 0, pack.init[:, :, None], sw.neg)
    return cur.expand(sw.P.B, 3, sw.P.W).contiguous()


def _fwd_step(sw: _Sweep, g: int, prev1, prev2):
    """Forward diagonal g >= 1 of every problem from the _padded previous
    two: returns (grid rows of diagonal g, cells (B, 3, W))."""
    P = sw.P
    # per target state (m, gx, gy) the source cell (x-1, y-1), (x-1, y),
    # (x, y-1), read at the three terms' states, plus each term's
    # transition: (B, target, term, W)
    src = torch.stack([prev2, prev1, prev1.index_select(1, sw.up)], dim=1)
    t = P.shift(src, g) + sw.tr
    rows, vm, e = P.at(g)
    # the three states' 3-way logAdds in one call: each element sees the
    # Pallas kernel's operations in its order
    cur = e + sw.la3(t[:, :, 0], t[:, :, 1], t[:, :, 2])
    return rows, torch.maximum(torch.where(vm, cur, sw.neg), sw.neg)


def _bwd_step(sw: _Sweep, g: int, next1, next2, bwd_final):
    """Backward diagonal g of every problem from the _padded next two:
    returns (grid rows, band mask (B, 1, W), cells (B, 3, W), the "to"
    terms (B, 3, W): each successor's backward value plus the emission
    consumed leaving the cell, targets (gapX, match, gapY)); the final
    diagonal carries the end weights (pairwiseAligner.c:882-892)."""
    P = sw.P
    # gapX of (x+1, y), match of (x+1, y+1), gapY of (x, y+1)
    src = torch.stack([next1[:, GAPX], next2[:, MATCH], next1[:, GAPY]],
                      dim=1)
    rows, vm, e = P.at(g)
    to = P.shift(src, g) + e
    # per term, plus its transition out of each state: (B, term, state, W)
    t = to[:, :, None, :] + sw.tr
    computed = torch.maximum(
        torch.where(vm, sw.la3(t[:, 0], t[:, 1], t[:, 2]), sw.neg), sw.neg)
    at_final = (P.D == g)[:, None, None]
    return rows, vm, torch.where(at_final, bwd_final, computed), to


def _bwd_final(pack: BandPack, sw: _Sweep) -> torch.Tensor:
    kf = pack.k_final.long()[:, None]
    return torch.where((sw.P.k == kf)[:, None, :], pack.end_w[:, :, None],
                       sw.neg)                                  # (B, 3, W)


def _posterior(f, b, total, vm):
    """exp(min(f + b - total, 0)) in the band, 0 outside."""
    zero = torch.zeros((), dtype=torch.float32, device=f.device)
    return torch.where(vm, torch.exp(torch.minimum(f + b - total, zero)),
                       zero)


def _corner_totals(pack: BandPack, sw: _Sweep, last: torch.Tensor):
    """Total log prob at the final corner with the end weights
    (pallas_banded.py:401-411); last = (B, 3, W) final diagonals."""
    f3 = torch.gather(last, 2, pack.k_final.long()[:, None, None]
                      .expand(sw.P.B, 3, 1))[:, :, 0]
    t = f3 + pack.end_w
    return sw.la(sw.la(t[:, 0], t[:, 1]), t[:, 2])


def fb_forward_plain(pack: BandPack, use_lut: bool):
    """Plain PyTorch twin of K2-fwd (the Pallas `_fwd_kernel` recurrence,
    pallas_banded.py:206-247), vectorised over the pack's problems."""
    sw = _Sweep(pack, "fwd", use_lut)
    P = sw.P
    # one spare row takes the diagonals beyond each problem's depth, so no
    # step selects its live problems (a device sync on a card)
    fwd = torch.empty((pack.n_rows + 1, 3, P.W), dtype=torch.float32,
                      device=pack.device)
    cur = _init_diag(pack, sw)
    fwd[pack.geo_off] = cur
    prev1, prev2 = _padded(cur), _padded(sw.empty())
    for g in range(1, P.Dmax):
        rows, cur = _fwd_step(sw, g, prev1, prev2)
        fwd[rows] = cur
        prev2, prev1 = prev1, _padded(cur)
    fwd = fwd[:pack.n_rows]
    return fwd, _corner_totals(pack, sw, fwd[pack.geo_off + P.D])


def fb_backward_plain(pack: BandPack, fwd: torch.Tensor,
                      totals: torch.Tensor, use_lut: bool) -> torch.Tensor:
    """Plain PyTorch twin of K2-bwd (the Pallas `_bwd_kernel` recurrence,
    pallas_banded.py:294-340)."""
    return _bwd_plain(pack, fwd, totals, use_lut, expectations=False)


def fb_words_plain(pack: BandPack, fwd: torch.Tensor, totals: torch.Tensor,
                   use_lut: bool, threshold: float):
    """Plain twin of K2-bwd WORDS: fb_backward_plain's posterior grid, then
    banded.extract_packed's selection and words. Returns (lo, hi)."""
    from margin_tpu_torch.ops import banded
    post = fb_backward_plain(pack, fwd, totals, use_lut)
    packed = banded.extract_packed(post, totals, pack, threshold)
    n, B = int(packed[0]), pack.B
    return packed[1 + B:1 + B + n], packed[1 + B + n:]


# [from, to] transitions of the expectations, states (match, gapX, gapY)
_TMAT = ((T_MM, T_OPEN_X, T_OPEN_Y), (T_M_FROM_GX, T_EXT_X, T_SW_Y),
         (T_M_FROM_GY, T_SW_X, T_EXT_Y))
_TO_ORDER = (1, 0, 2)   # _bwd_step's (gapX, match, gapY) -> (m, gx, gy)


def fb_expectations_plain(pack: BandPack, fwd: torch.Tensor,
                          totals: torch.Tensor,
                          use_lut: bool) -> torch.Tensor:
    """Plain PyTorch twin of K4 and K5-exp, in margin_tpu's order
    (ops/banded.py:_banded_fb_core :478-486 with compute_expectations):
    per diagonal, last first, every band cell's exp(f[from] + to[to] +
    t[from, to] - total), summed over the band, then added into a (3, 3)
    float32 accumulator. Returns (B, 3, 3)."""
    return _bwd_plain(pack, fwd, totals, use_lut, expectations=True)


def _bwd_plain(pack: BandPack, fwd: torch.Tensor, totals: torch.Tensor,
               use_lut: bool, expectations: bool) -> torch.Tensor:
    """The backward walk of fb_backward_plain (posterior grid) or of
    fb_expectations_plain (expectations)."""
    sw = _Sweep(pack, "bwd", use_lut)
    P = sw.P
    dev = pack.device
    # a spare row, as in fb_forward_plain; beyond a problem's depth the
    # band mask is empty, so the posterior written there is 0
    post = None if expectations else torch.zeros(
        (pack.n_rows + 1, 3, P.W), dtype=torch.float32, device=dev)
    acc = torch.zeros((P.B, 3, 3), dtype=torch.float32, device=dev)
    tmat = pack.trans[:, torch.tensor(_TMAT, device=dev)][..., None]
    to_order = torch.tensor(_TO_ORDER, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    f_rows = P.rows.clamp(max=pack.n_rows - 1)
    next1 = next2 = _padded(sw.empty())
    bwd_final = _bwd_final(pack, sw)
    total = totals[:, None, None]
    for g in range(P.Dmax - 1, -1, -1):
        rows, vm, cur, to = _bwd_step(sw, g, next1, next2, bwd_final)
        f = fwd[f_rows[:, g]]
        if expectations:
            to = to.index_select(1, to_order)
            contrib = torch.exp(f[:, :, None, :] + to[:, None, :, :] + tmat
                                - total[..., None])
            acc = acc + torch.where(vm[:, :, None, :], contrib, zero).sum(-1)
        else:
            post[rows] = _posterior(f, cur, total, vm)
        next2, next1 = next1, _padded(cur)
    return acc if expectations else post[:pack.n_rows]


def seg_forward_plain(pack: BandPack, use_lut: bool, seg_d: int):
    """Plain twin of K3-fwd: the K2 twin's forward steps, keeping only the
    carry into every segment of seg_d diagonals and the final corners."""
    sw = _Sweep(pack, "fwd", use_lut)
    P = sw.P
    seg_off, n_total = seg_layout(pack, seg_d)
    ckpt = torch.full((n_total, 2, 3, P.W), LOG_ZERO, dtype=torch.float32,
                      device=pack.device)
    cur = _init_diag(pack, sw)
    last = cur.clone()
    prev1, prev2 = _padded(cur), _padded(sw.empty())
    for g in range(1, P.Dmax):
        live = g <= P.D
        if g % seg_d == 0:
            idx = seg_off[live] + g // seg_d
            ckpt[idx, 0] = prev1[live][..., 1:-1]
            ckpt[idx, 1] = prev2[live][..., 1:-1]
        _, cur = _fwd_step(sw, g, prev1, prev2)
        last = torch.where((P.D == g)[:, None, None], cur, last)
        prev2, prev1 = prev1, _padded(cur)
    return ckpt, _corner_totals(pack, sw, last)


def seg_backward_plain(pack: BandPack, ckpt: torch.Tensor,
                       totals: torch.Tensor, use_lut: bool, seg_d: int,
                       threshold: float):
    """Plain twin of K3-bwd: per segment, last first, the forward recomputed
    from its checkpoint into a (B, seg_d, 3, W) block, then the backward
    through it with the carry of the later segments, and the posterior
    cells >= threshold as extraction words (lo, hi)."""
    fw = _Sweep(pack, "fwd", use_lut)
    sw = _Sweep(pack, "bwd", use_lut)
    P = sw.P
    B, W = P.B, P.W
    seg_off, _ = seg_layout(pack, seg_d)
    k = P.k
    next1 = next2 = _padded(sw.empty())
    bwd_final = _bwd_final(pack, sw)
    total = totals[:, None, None]
    los, his = [], []
    for seg in range(int(P.D.max()) // seg_d, -1, -1):
        d0 = seg * seg_d
        d1 = min(d0 + seg_d, P.Dmax)
        blk = torch.empty((B, d1 - d0, 3, W), dtype=torch.float32,
                          device=pack.device)
        if seg == 0:
            cur = _init_diag(pack, fw)
            blk[:, 0] = cur
            prev1, prev2 = _padded(cur), _padded(fw.empty())
            g0 = 1
        else:
            live = d0 <= P.D
            carry = torch.full((B, 2, 3, W), LOG_ZERO, dtype=torch.float32,
                               device=pack.device)
            carry[live] = ckpt[seg_off[live] + seg]
            prev1, prev2 = _padded(carry[:, 0]), _padded(carry[:, 1])
            g0 = d0
        for g in range(g0, d1):
            _, cur = _fwd_step(fw, g, prev1, prev2)
            blk[:, g - d0] = cur
            prev2, prev1 = prev1, _padded(cur)
        post = torch.empty_like(blk)
        for g in range(d1 - 1, d0 - 1, -1):
            _, vm, cur, _ = _bwd_step(sw, g, next1, next2, bwd_final)
            post[:, g - d0] = _posterior(blk[:, g - d0], cur, total, vm)
            next2, next1 = next1, _padded(cur)
        # extraction (banded.extract_packed's selection and words)
        diag = torch.arange(d0, d1, device=pack.device)             # (n,)
        xm = P.xmy[:, d0:d1]                                        # (B, n)
        xb = torch.div(diag + xm, 2, rounding_mode="floor") - 1
        yb = torch.div(diag - xm, 2, rounding_mode="floor") - 1
        x_ok = (xb[..., None] + 1 + k) > 0                          # (B,n,W)
        y_ok = (yb[..., None] + 1 - k) > 0
        sel = post >= threshold
        sel[:, :, MATCH] &= x_ok & y_ok
        sel[:, :, GAPX] &= x_ok
        sel[:, :, GAPY] &= y_ok
        sel &= (diag[None, :] <= P.D[:, None])[:, :, None, None]
        b_i, d_i, s_i, k_i = torch.nonzero(sel, as_tuple=True)
        probs = torch.floor(torch.clamp(post[b_i, d_i, s_i, k_i], max=1.0)
                            * 10_000_000).to(torch.int32)
        los.append(probs | (k_i.to(torch.int32) << 24))
        his.append((d0 + d_i).to(torch.int32)
                   | ((b_i * 3 + s_i).to(torch.int32) << 22))
    return torch.cat(los), torch.cat(his)


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


def fb_posteriors_words(tables, items, w_pad: int, expansion: int,
                        use_lut: bool, dynamic: bool, use_rle: bool,
                        threshold: float, geoms_in=None, device="cuda"):
    """Solve one pack (as fb_posteriors_group) into its extraction words:
    K2-fwd, then K2-bwd WORDS on a CUDA device (the plain twins on the
    CPU). Returns (the fused int32 readback [count, totals, lo words, hi
    words] on `device`, pack): banded.extract_packed's words, in another
    order, with no posterior grid made."""
    pack = _pack_host(tables, items, w_pad, expansion, dynamic, use_rle,
                      geoms_in, device)
    fwd, totals = fb_forward(pack, use_lut)
    lo, hi = fb_backward_words(pack, fwd, totals, use_lut, threshold)
    return _fused(totals, lo, hi), pack


def _fused(totals, lo, hi) -> torch.Tensor:
    """[count, totals (bit-cast), lo words, hi words], the layout of
    banded.extract_packed."""
    count = torch.tensor([lo.numel()], dtype=torch.int32, device=lo.device)
    return torch.cat([count, totals.contiguous().view(torch.int32), lo, hi])


def fb_posteriors_seg(tables, items, w_pad: int, expansion: int,
                      use_lut: bool, dynamic: bool, use_rle: bool,
                      threshold: float, seg_d: int, geoms_in=None,
                      device="cuda"):
    """Solve one deep pack with the segmented forward-backward (K3-fwd,
    K3-bwd on a CUDA device). Returns (the fused int32 readback
    [count, totals, lo words, hi words] on `device`, pack); the words are
    those `banded.extract_packed` builds from the monolithic posteriors,
    in another order."""
    pack = _pack_host(tables, items, w_pad, expansion, dynamic, use_rle,
                      geoms_in, device)
    ckpt, totals = seg_forward(pack, use_lut, seg_d)
    lo, hi = seg_backward(pack, ckpt, totals, use_lut, seg_d, threshold)
    return _fused(totals, lo, hi), pack


def fb_posteriors_seg_plain(pack: BandPack, use_lut: bool, threshold: float,
                            seg_d: int) -> torch.Tensor:
    """The plain twins of K3-fwd and K3-bwd on a pack, on its device:
    the fused readback of `fb_posteriors_seg`."""
    ckpt, totals = seg_forward_plain(pack, use_lut, seg_d)
    lo, hi = seg_backward_plain(pack, ckpt, totals, use_lut, seg_d,
                                threshold)
    return _fused(totals, lo, hi)
