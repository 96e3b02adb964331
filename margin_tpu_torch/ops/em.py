"""Baum-Welch EM over the banded pair-HMM: transition-expectation
accumulation and re-estimation.

Counterpart of `margin_tpu/ops/em.py`, with an explicit `device` for
em_iteration's tables. The expectations come from
`banded.banded_expectations(_many)`: kernel K4 on a CUDA device, its plain
twin on the CPU. Parity: Hmm accumulator (stateMachine.c:154-203, hmm_addToTransition-
Expectation :280-288, hmm_normalise :318-338) + getExpectations
(pairwiseAligner.c:1193-1209). As in the reference, emission training is
disabled (pairwiseAligner.c:361-364) — EM re-estimates the nine transition
probabilities only.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from margin_tpu_torch.ops import banded
from margin_tpu_torch.ops.pairhmm import PairHmmTables
from margin_tpu_torch.params import StateMachineParams


class HmmExpectations:
    """Hmm (stateMachine.c:154-203): (3,3) [from, to] transition expected
    counts with states 0=match, 1=gapX, 2=gapY, plus an accumulated
    likelihood."""

    def __init__(self, pseudo_expectation: float = 0.0):
        self.trans = np.full((3, 3), pseudo_expectation, dtype=np.float64)
        self.likelihood = 0.0

    def add_expectations(self, tables: PairHmmTables, x_sym: np.ndarray,
                         y_sym: np.ndarray, anchors=None, expansion: int = 20,
                         strand: int = 0, ragged_left: bool = False,
                         ragged_right: bool = False,
                         use_lut: bool = False) -> float:
        """getExpectations (pairwiseAligner.c:1203-1209) for one sequence
        pair; returns its total log probability."""
        e, total = banded.banded_expectations(
            tables, x_sym, y_sym, anchors, expansion, strand,
            ragged_left, ragged_right, use_lut)
        self.trans += e
        self.likelihood += total
        return total

    def normalise(self) -> np.ndarray:
        """hmm_normalise (stateMachine.c:318-327): row-normalize into
        transition probabilities (returned, and kept in self.trans)."""
        totals = self.trans.sum(axis=1, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            self.trans = np.where(totals > 0, self.trans / totals, 0.0)
        return self.trans

    def to_state_machine_params(self, base: StateMachineParams
                                ) -> StateMachineParams:
        """hmm_getStateMachine analogue: a new StateMachineParams with the
        (normalized) transitions installed, emissions kept from `base`
        (emission training is disabled, pairwiseAligner.c:361-364)."""
        T = self.trans

        def lg(v):
            return math.log(v) if v > 0 else -1e30

        return dataclasses.replace(
            base,
            t_match_continue=lg(T[0, 0]),
            t_match_from_gap_x=lg(T[1, 0]),
            t_match_from_gap_y=lg(T[2, 0]),
            t_gap_open_x=lg(T[0, 1]),
            t_gap_open_y=lg(T[0, 2]),
            t_gap_extend_x=lg(T[1, 1]),
            t_gap_extend_y=lg(T[2, 2]),
            t_gap_switch_to_x=lg(T[2, 1]),
            t_gap_switch_to_y=lg(T[1, 2]))


def em_iteration(sm: StateMachineParams, pairs, expansion: int = 20,
                 pseudo_expectation: float = 1e-12,
                 use_lut: bool = False, device="cuda"):
    """One Baum-Welch iteration over (x_sym, y_sym) pairs
    (tests/pairwiseAlignerTest.c test_em structure). Returns
    (updated StateMachineParams, summed log likelihood). The pairs are
    solved together (one K2-fwd and one K4 launch per pack of 128) and
    added in input order, as add_expectations would add them one by one."""
    tables = PairHmmTables.from_params(sm, device=device)
    hmm = HmmExpectations(pseudo_expectation)
    items = [{"x_sym": np.asarray(x), "y_sym": np.asarray(y), "anchors": [],
              "strand": 0} for x, y in pairs]
    for e, total in banded.banded_expectations_many(tables, items, expansion,
                                                    use_lut=use_lut):
        hmm.trans += e
        hmm.likelihood += total
    likelihood = hmm.likelihood
    hmm.normalise()
    return hmm.to_state_machine_params(sm), likelihood
