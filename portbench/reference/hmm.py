"""The pair-HMM's tables, worked out from the params JSON the benchmark
wrote, with nothing taken from the program.

Margin's 3-state pair-HMM (stateMachine.c): states match, gap X (consumes
the first sequence, the reference side) and gap Y (consumes the second,
the read). The trained-HMM JSON (type 3, asymmetric) gives 3x3 transition
probabilities [from][to] and 16 match + 4 + 4 gap emission
probabilities; every N emits log(1/16) in a match and log(1/4) in a gap.
The reverse strand relabels base b as 3 - b (stateMachine.c:457-473).
With `useRepeatCountsInAlignment` the match emission gains
2.3025 x the log10 repeat-count probability of (underlying run length of
x, observed run length of y) for x's base, read on the reverse strand
from base 3 - b (repeatSubMatrix.c:11-43, stateMachine.c:716-752).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

LOG_ZERO = -1.0e30
REPEAT = 51
# transition vector layout: match continue; match from gap X, gap Y; gap
# open X, Y; extend X, Y; switch to X (from gap Y), to Y (from gap X)
(T_MM, T_M_FROM_GX, T_M_FROM_GY, T_OPEN_X, T_OPEN_Y, T_EXT_X, T_EXT_Y,
 T_SW_X, T_SW_Y) = range(9)


@dataclass
class Tables:
    """float64 tables, strand-stacked: match (2, 5, 5) [x base][y base],
    gap_x (2, 5), gap_y (2, 5), trans (2, 9), repeat (2, 4, 51, 51)
    [x base][underlying][observed] in natural logs, or None."""
    match: np.ndarray
    gap_x: np.ndarray
    gap_y: np.ndarray
    trans: np.ndarray
    repeat: Optional[np.ndarray]


def _log(p: float) -> float:
    return math.log(p) if p > 0 else LOG_ZERO


def tables_from_params(doc: dict) -> Tables:
    pol = doc["polish"]
    hmm = pol["hmmForwardStrandReadGivenReference"]
    if int(hmm["type"]) != 3 or int(hmm.get("emissionsType", 0)) != 0:
        raise ValueError("the reference reads asymmetric nucleotide HMMs")
    T = np.asarray(hmm["transitions"], np.float64).reshape(3, 3)
    E = np.asarray(hmm["emissions"], np.float64)
    trans = np.array([_log(T[0, 0]), _log(T[1, 0]), _log(T[2, 0]),
                      _log(T[0, 1]), _log(T[0, 2]), _log(T[1, 1]),
                      _log(T[2, 2]), _log(T[2, 1]), _log(T[1, 2])])
    with np.errstate(divide="ignore"):
        m4, gx4, gy4 = (np.log(E[:16]).reshape(4, 4), np.log(E[16:20]),
                        np.log(E[20:24]))
    match = np.full((5, 5), math.log(1 / 16))
    match[:4, :4] = m4
    gx, gy = np.full(5, math.log(0.25)), np.full(5, math.log(0.25))
    gx[:4], gy[:4] = gx4, gy4
    perm = np.array([3, 2, 1, 0, 4])

    def clamp(a):
        return np.maximum(np.nan_to_num(a, neginf=LOG_ZERO), LOG_ZERO)
    rep = None
    if pol.get("useRepeatCountsInAlignment"):
        m = pol["repeatCountSubstitutionMatrix"]
        fwd = np.stack([np.asarray(
            m[f"repeatCountLogProbabilities_{b}_F"], np.float64).reshape(
                REPEAT, REPEAT) for b in "ACGT"])
        rep = 2.3025 * np.stack([fwd, fwd[::-1]])
    return Tables(clamp(np.stack([match, match[np.ix_(perm, perm)]])),
                  clamp(np.stack([gx, gx[perm]])),
                  clamp(np.stack([gy, gy[perm]])),
                  clamp(np.stack([trans, trans])), rep)
