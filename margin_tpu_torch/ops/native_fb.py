"""ctypes binding for the native banded FB (native/marginfb.cc).

Bands wider than the pack kernels' 128 cells run here at C speed with
flat ragged-band storage — the same work the reference's
pairwiseAligner.c does on CPU — exactly as the JAX package routes them on
an accelerator (margin_tpu/ops/banded.py:1173-1179). The library is built
by `margin_tpu_torch._ext` into the port's build directory.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    from margin_tpu_torch import _ext
    L = _ext.native_lib("marginfb")
    if L is None:
        return None
    L.mfb_posteriors.restype = ctypes.c_int64
    L.mfb_posteriors.argtypes = [
        _I32P, ctypes.c_int64, _I32P, ctypes.c_int64,          # x, y
        _I64P, _I64P,                                          # band lo/hi
        _F32P, _F32P, _F32P, _F32P,                            # tables
        ctypes.c_void_p,                                       # rep_tab
        ctypes.c_void_p, ctypes.c_void_p,                      # rep_x/y
        ctypes.c_int, ctypes.c_int, ctypes.c_int,              # flags
        _F64P, _F64P, ctypes.c_double,                         # LUT
        ctypes.c_float,
        _I32P, ctypes.c_int64, _F64P,
    ]
    _LIB = L
    return _LIB


def posteriors_item(tables, item, expansion: int, threshold: float,
                    use_lut: bool, dynamic: bool):
    """Solve one item; returns ((matches, gapx, gapy), total) in the same
    format as banded_posteriors (int64 (prob, x, y) rows sorted by x, y)."""
    from margin_tpu_torch.ops import logmath
    from margin_tpu_torch.testing.oracle import build_band

    L = lib()
    assert L is not None
    x_sym = np.ascontiguousarray(item["x_sym"], dtype=np.int32)
    y_sym = np.ascontiguousarray(item["y_sym"], dtype=np.int32)
    lx, ly = len(x_sym), len(y_sym)
    anchors = item["anchors"]
    band = build_band([] if anchors is None else anchors, lx, ly, expansion,
                      dynamic=dynamic)
    band_lo = np.ascontiguousarray(band[:, 0], dtype=np.int64)
    band_hi = np.ascontiguousarray(band[:, 1], dtype=np.int64)
    strand = int(item["strand"])
    match25 = np.ascontiguousarray(tables.host["match"][strand],
                                   dtype=np.float32)
    gapx5 = np.ascontiguousarray(tables.host["gap_x"][strand],
                                 dtype=np.float32)
    gapy5 = np.ascontiguousarray(tables.host["gap_y"][strand],
                                 dtype=np.float32)
    trans9 = np.ascontiguousarray(tables.host["trans"][strand],
                                  dtype=np.float32)
    use_rle = item.get("rep_x") is not None and tables.repeat is not None
    if use_rle:
        rep_tab = np.ascontiguousarray(tables.host["repeat"][strand],
                                       dtype=np.float32)
        rep_x = np.ascontiguousarray(item["rep_x"], dtype=np.int32)
        rep_y = np.ascontiguousarray(item["rep_y"], dtype=np.int32)
        rt = rep_tab.ctypes.data_as(ctypes.c_void_p)
        rx = rep_x.ctypes.data_as(ctypes.c_void_p)
        ry = rep_y.ctypes.data_as(ctypes.c_void_p)
    else:
        rt = rx = ry = None
    breaks = np.ascontiguousarray(logmath.BREAKS, dtype=np.float64)
    cubic = np.ascontiguousarray(logmath.CUBIC.reshape(-1),
                                 dtype=np.float64)
    total = np.zeros(1, dtype=np.float64)

    cap = 4 * (lx + ly) + 1024
    while True:
        out = np.empty((cap, 4), dtype=np.int32)
        n = L.mfb_posteriors(
            x_sym, lx, y_sym, ly, band_lo, band_hi,
            match25, gapx5, gapy5, trans9, rt, rx, ry,
            int(bool(item.get("ragged_left"))),
            int(bool(item.get("ragged_right"))),
            int(bool(use_lut)), breaks, cubic,
            float(logmath.LOG_UNDERFLOW_THRESHOLD),
            float(threshold), out, cap, total)
        if n >= 0:
            break
        cap *= 4
    out = out[:n]
    res = []
    for s in range(3):
        rows = out[out[:, 0] == s]
        pairs = np.stack([rows[:, 3], rows[:, 1], rows[:, 2]],
                         axis=1).astype(np.int64)
        order = np.lexsort((pairs[:, 2], pairs[:, 1]))
        res.append(pairs[order])
    return (tuple(res),
            0.0 if total[0] == -np.inf and n == 0 else float(total[0]))
