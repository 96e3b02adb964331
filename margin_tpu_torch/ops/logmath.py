"""Log-space math on tensors: the reference's LUT logAdd and the exact
logAdd.

The reference computes log(exp(d)+1) with a piecewise cubic
(pairwiseAligner.c:279-299). The JAX package writes it twice, with the same
arithmetic: `logmath.log_add_lut_finite` (:68-76, cubic at :35-49) for the
dense forward and `pallas_banded._lut_log_add` (:86-106) for the banded
kernels. Both take hi = max, lo = min, d = hi - lo, pick the coefficient
row by the breaks (d > 1.0, > 2.5, > 4.5), evaluate
((c0*d + c1)*d + c2)*d + c3, add lo, and return hi where d >= 7.5. The DP
values are clamped at a finite LOG_ZERO, so d >= 0 always and the Pallas
form's clip of d to [0, 7.5] never changes a selected value: one function
here reproduces both, operation for operation and unfused, in float32.
The CUDA kernels carry the same arithmetic (csrc/logadd.cuh).
"""

from __future__ import annotations

import numpy as np
import torch

LOG_UNDERFLOW_THRESHOLD = 7.5

# pairwiseAligner.c:282-293; rows: d<=1.0, d<=2.5, d<=4.5, d<=7.5;
# columns a,b,c,d of ((a*x+b)*x+c)*x+d
CUBIC = np.array([
    [-0.009350833524763, 0.130659527668286, 0.498799810682272, 0.693203116424741],
    [-0.014532321752540, 0.139942324101744, 0.495635523139337, 0.692140569840976],
    [-0.004605031767994, 0.063427417320019, 0.695956496475118, 0.514272634594009],
    [-0.000458661602210, 0.009695946122598, 0.930734667215156, 0.168037164329057],
], dtype=np.float64)

BREAKS = np.array([1.0, 2.5, 4.5], dtype=np.float64)

# float64 constants rounded once to float32, as the JAX kernels do; one
# copy per device
_TABLES = {}


def _tables(device: torch.device):
    """(coefficients transposed (4, 4): row j holds column j of CUBIC,
    breaks) on `device`."""
    t = _TABLES.get(device)
    if t is None:
        t = _TABLES[device] = (
            torch.tensor(CUBIC.T.copy(), dtype=torch.float32, device=device),
            torch.tensor(BREAKS, dtype=torch.float32, device=device))
    return t


def log_add_lut(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """logAdd with the reference's LUT semantics for finite inputs."""
    hi = torch.maximum(x, y)
    lo = torch.minimum(x, y)
    d = hi - lo
    cubic_t, breaks = _tables(d.device)
    # row 0 for d <= 1.0, 1 for d <= 2.5, 2 for d <= 4.5, else 3
    c0, c1, c2, c3 = cubic_t[:, torch.bucketize(d, breaks)]
    approx = ((c0 * d + c1) * d + c2) * d + c3
    approx = approx + lo
    return torch.where(d >= LOG_UNDERFLOW_THRESHOLD, hi, approx)


def log_add_exact(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact logaddexp (numerically stable)."""
    return torch.logaddexp(x, y)


def log_add_fn(use_lut: bool):
    return log_add_lut if use_lut else log_add_exact


# float64 numpy versions, for the host-side POA consensus
# (margin_tpu/ops/logmath.py:92-108)

def np_lookup(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    idx = (x > BREAKS[0]).astype(np.int64) + (x > BREAKS[1]) + (x > BREAKS[2])
    coeff = CUBIC[idx]
    return ((coeff[..., 0] * x + coeff[..., 1]) * x + coeff[..., 2]) * x \
        + coeff[..., 3]


def np_log_add_lut(x, y):
    """Scalar/array numpy twin of the reference logAdd
    (pairwiseAligner.c:295-299), -inf aware."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    hi = np.maximum(x, y)
    lo = np.minimum(x, y)
    with np.errstate(invalid="ignore"):
        d = hi - lo
    use_hi = np.isinf(lo) | np.isnan(d) | (d >= LOG_UNDERFLOW_THRESHOLD)
    d_safe = np.where(use_hi, 0.0, d)
    return np.where(use_hi, hi, np_lookup(d_safe) + lo)
