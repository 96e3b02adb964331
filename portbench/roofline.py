"""The yardstick of the kernels: the published peaks of one H100 and the
operations and bytes each launch of K1, K2 and K3 needs, counted from the
shapes of its inputs (frozen copies of `chip_smoke.py`'s `k1_work`,
`k2_work`, `words_work`, `k3_work` and their per-cell operation counts).

Each input byte is counted once and each output byte once; K3's
recompute of a segment's forward is its design's cost, not work. A
roofline share is the least time the chip could take (the larger of the
operations over the float32 peak and the bytes over the memory
bandwidth) over the time the kernel took.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# NVIDIA H100 SXM data sheet, dense: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_NOTE = "H100 SXM float32 67 TFLOP/s, HBM3 3.35 TB/s (at 700 W)"

# float ops per band cell. logAdd, LUT: max, min, sub, 4 compares, cubic
# (3 mul + 3 add), add, select = 15; exact: max, sub, abs, exp, log1p,
# add = 6. Forward cell: 3 states x (3 transition adds + 2 logAdds +
# emission add + clamp). Backward cell: 3 states x (6 adds + 2 logAdds +
# clamp) + 3 posteriors x (add, sub, min, exp).
_LOGADD = {True: 15, False: 6}
REPEAT = 51
# deepest K3 segment per band-width bucket (the program's SEG_D)
SEG_D = {16: 752, 32: 416, 64: 208, 128: 96}
MAX_PACK_W = 128
SEG_MIN_D = 16384            # items with more diagonals take K3
MAX_DIAGONALS = 1 << 22


def fwd_ops_per_cell(lut: bool) -> int:
    return 3 * (5 + 2 * _LOGADD[lut])


def bwd_ops_per_cell(lut: bool) -> int:
    return 3 * (7 + 2 * _LOGADD[lut]) + 12


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def k1_work(B: int, Lx: int, Ly: int, lxs, lys, lut: bool,
            rle: bool = False):
    """(operations, bytes) of one K1 launch: B pairs padded to (Lx, Ly),
    true lengths lxs, lys; every cell of each pair's (lx+1) x (ly+1)
    rectangle but the origin; the padded symbols, three int32 and two
    bool per pair in, one float32 total out; with RLE the run lengths and
    the repeat table."""
    lx = np.asarray(lxs, np.int64)
    ly = np.asarray(lys, np.int64)
    cells = int(np.maximum((lx + 1) * (ly + 1) - 1, 0).sum())
    nbytes = B * Lx + B * Ly + 4 * 3 * B + 2 * B + 4 * B
    if rle:
        nbytes += 4 * (B * Lx + B * Ly) + 2 * 4 * REPEAT * REPEAT * 4
    return cells * fwd_ops_per_cell(lut), nbytes


# ---------------------------------------------------------------------------
# the banded items: margin's band, its smoothed storage and the route
# ---------------------------------------------------------------------------

class ItemShape:
    """What a banded item's launch shapes follow from: its lengths, its
    exact band cells, its storage width (the band's lower bound smoothed
    to move by one a diagonal) and so its route."""

    def __init__(self, lx: int, ly: int, band: np.ndarray):
        self.lx, self.ly = lx, ly
        lo, hi = band[:, 0].astype(np.int64), band[:, 1].astype(np.int64)
        self.cells = int(np.maximum((hi - lo) // 2 + 1, 0).sum())
        n = len(lo)
        if n > 1:
            d = np.arange(n)
            s = np.minimum(np.minimum.accumulate(lo - d) + d,
                           np.minimum.accumulate((lo + d)[::-1])[::-1] - d)
        else:
            s = lo
        self.w_pad = int(((hi - s) // 2 + 1).max())

    @property
    def diagonals(self) -> int:
        return self.lx + self.ly + 1

    @property
    def route(self) -> str:
        """'host' (the host engine), 'k3' or 'k2', as the program routes
        an item of these shapes."""
        if self.w_pad > MAX_PACK_W or self.diagonals > MAX_DIAGONALS:
            return "host"
        if self.diagonals > SEG_MIN_D:
            return "k3"
        return "k2"

    @property
    def bucket(self) -> int:
        for b in (16, 32, 64):
            if self.w_pad <= b:
                return b
        return 128


def _input_bytes(shape: ItemShape, rle: bool) -> int:
    """An item's share of its pack's inputs, each read once: symbols
    (and run lengths) of both sequences, the per-diagonal geometry (three
    int32), and the per-problem tables and scalars."""
    n_sym = shape.lx + shape.ly
    nbytes = n_sym + 12 * shape.diagonals + 4 * (35 + 9 + 6) + 4 * 5 + 8 * 3
    if rle:
        nbytes += 4 * n_sym + 4 * 4 * REPEAT * REPEAT
    return nbytes


def k2_work(shape: ItemShape, lut: bool, rle: bool, n_words: int = 0):
    """(forward, words) (operations, bytes) of an item on K2-fwd then
    K2-bwd's WORDS instance: the forward's cells, its grid written at the
    pack's width and its total; the backward's cells, the grid and total
    read, the words written."""
    grid = shape.diagonals * 3 * shape.bucket * 4
    inp = _input_bytes(shape, rle)
    fwd = (shape.cells * fwd_ops_per_cell(lut), inp + grid + 4)
    bwd = (shape.cells * bwd_ops_per_cell(lut), inp + grid + 4 + 8 * n_words)
    return fwd, bwd


def k3_work(shape: ItemShape, lut: bool, rle: bool, n_words: int = 0):
    """(forward, backward) (operations, bytes) of an item on K3: the
    forward's cells with its checkpoints (two diagonals a segment) and
    total written; the backward's cells with the checkpoints read and the
    words written."""
    seg = (shape.lx + shape.ly) // SEG_D[shape.bucket] + 1
    ckpt = seg * 2 * 3 * shape.bucket * 4
    inp = _input_bytes(shape, rle)
    return ((shape.cells * fwd_ops_per_cell(lut), inp + ckpt + 4),
            (shape.cells * bwd_ops_per_cell(lut), inp + ckpt + 4
             + 8 * n_words))


def share(bound: float, device_s: float) -> Optional[float]:
    """A roofline share in percent, or None where nothing ran."""
    if device_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device_s
