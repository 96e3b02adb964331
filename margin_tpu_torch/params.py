"""Hierarchical JSON parameter loading.

Loads the reference's own parameter files unchanged (params/base_params.json,
params/phase/*.json, params/polish/**). Parity: impl/parser.c.

Semantics:
  - Top-level keys: "include" (path relative to the including file, parsed
    in-place so earlier/included values are overridden by later keys;
    parser.c:565-619), "polish", "phase".
  - The polish block embeds the trained alignment HMM
    ("hmmForwardStrandReadGivenReference", parser.c:344-359) and the repeat
    count substitution matrix — config = model checkpoint.
  - Unknown keys are hard errors (parser.c:180-182, 486).

The loaded HMM is converted to dense log-space transition/emission arrays for
the device kernels (see ops/pairhmm.py). The reverse-strand machine's
emissions are the reverse-complement transform (stateMachine.c:457-473).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field, fields
from typing import Optional

import numpy as np

LOG_ZERO = -np.inf

MAXIMUM_REPEAT_LENGTH = 51  # margin.h:133
MAX_READ_PARTITIONING_DEPTH = 64  # margin.h:142


def _log(x: float) -> float:
    return math.log(x) if x > 0 else LOG_ZERO


@dataclass
class PairwiseAlignmentParameters:
    """Banded-DP parameters (pairwiseAligner.c:1048-1060 defaults,
    :1066-1102 JSON keys)."""
    threshold: float = 0.01
    minDiagsBetweenTraceBack: int = 1000
    traceBackDiagonals: int = 40
    diagonalExpansion: int = 20
    constraintDiagonalTrim: int = 14
    splitMatrixBiggerThanThis: int = 3000 * 3000
    alignAmbiguityCharacters: bool = False
    gapGamma: float = 0.5
    dynamicAnchorExpansion: bool = False

    def update_from_json(self, d: dict):
        known = {f.name for f in fields(self)}
        for k, v in d.items():
            if k not in known:
                raise ValueError(f"Unrecognised key in pairwise alignment parameters json: {k}")
            cur = getattr(self, k)
            setattr(self, k, type(cur)(v) if not isinstance(cur, bool) else bool(v))


@dataclass
class StateMachineParams:
    """Dense log-space 3-state pair-HMM parameters for one strand.

    States: 0=match, 1=gapX, 2=gapY (stateMachine.c:10-12). X is the
    first/reference-like sequence, Y the second/read-like sequence.

    Transition scalars mirror StateMachine3 (stateMachine.c:507-519);
    emissions are the 4x4 match matrix + per-symbol gap vectors with the
    N-handling defaults baked into 5x5 / length-5 arrays
    (stateMachine.c:363-383).
    """
    t_match_continue: float
    t_match_from_gap_x: float
    t_match_from_gap_y: float
    t_gap_open_x: float
    t_gap_open_y: float
    t_gap_extend_x: float
    t_gap_extend_y: float
    t_gap_switch_to_x: float
    t_gap_switch_to_y: float
    match_probs: np.ndarray  # (5,5) log probs incl. N row/col
    gap_x_probs: np.ndarray  # (5,) log probs incl. N
    gap_y_probs: np.ndarray  # (5,)

    @staticmethod
    def _expand_match(m4: np.ndarray) -> np.ndarray:
        out = np.full((5, 5), math.log(0.25 ** 2))  # N anywhere: log(1/16)
        out[:4, :4] = m4
        return out

    @staticmethod
    def _expand_gap(g4: np.ndarray) -> np.ndarray:
        out = np.full(5, math.log(0.25))  # N: log(0.25)
        out[:4] = g4
        return out

    @classmethod
    def from_hmm_json(cls, hmm: dict) -> "StateMachineParams":
        """Build from the JSON trained HMM (stateMachine.c:206-268 parse,
        :663-682 symmetric load, :646-661 asymmetric load)."""
        sm_type = int(hmm["type"])  # 2=threeState(symmetric), 3=asymmetric
        if int(hmm.get("emissionsType", 0)) != 0:
            raise ValueError("only nucleotideEmissions (0) supported")
        T = np.asarray(hmm["transitions"], dtype=np.float64).reshape(3, 3)
        E = np.asarray(hmm["emissions"], dtype=np.float64)
        assert E.shape[0] == 24, "expect 16 match + 4 gapX + 4 gapY emissions"
        with np.errstate(divide="ignore"):
            m4 = np.log(E[:16]).reshape(4, 4)
            gx4 = np.log(E[16:20])
            gy4 = np.log(E[20:24])
        if sm_type == 2:  # symmetric (stateMachine.c:663-682)
            t_mm = _log(T[0, 0])
            t_m_from_g = _log((T[1, 0] + T[2, 0]) / 2.0)
            t_open = _log((T[0, 1] + T[0, 2]) / 2.0)
            t_ext = _log((T[1, 1] + T[2, 2]) / 2.0)
            t_switch = _log((T[2, 1] + T[1, 2]) / 2.0)
            return cls(t_mm, t_m_from_g, t_m_from_g, t_open, t_open, t_ext,
                       t_ext, t_switch, t_switch,
                       cls._expand_match(m4), cls._expand_gap(gx4), cls._expand_gap(gy4))
        elif sm_type == 3:  # asymmetric (stateMachine.c:646-661)
            return cls(_log(T[0, 0]), _log(T[1, 0]), _log(T[2, 0]),
                       _log(T[0, 1]), _log(T[0, 2]), _log(T[1, 1]), _log(T[2, 2]),
                       _log(T[2, 1]), _log(T[1, 2]),
                       cls._expand_match(m4), cls._expand_gap(gx4), cls._expand_gap(gy4))
        raise ValueError(f"unsupported state machine type {sm_type}")

    @classmethod
    def default_nucleotide(cls, asymmetric: bool = False) -> "StateMachineParams":
        """Default constants (stateMachine.c:612-622, :409-432)."""
        del asymmetric  # same constants either way
        EM, ET, EV = -1.8917761142, -3.760242452, -4.3459578861
        m4 = np.array([[EM, EV, ET, EV], [EV, EM, EV, ET],
                       [ET, EV, EM, EV], [EV, ET, EV, EM]])
        g4 = np.full(4, -1.3862943611)
        return cls(-0.030064059121770816, -1.272871422049609, -1.272871422049609,
                   -4.21256642, -4.21256642, -0.3388262689231553, -0.3388262689231553,
                   -4.910694825551255, -4.910694825551255,
                   cls._expand_match(m4), cls._expand_gap(g4), cls._expand_gap(g4))

    def reverse_complement(self) -> "StateMachineParams":
        """Reverse-strand machine: complement-permute emission indices
        (stateMachine.c:457-473 does pairwise swaps == relabeling base b as
        3-b in both coordinates; N entries are symmetric already)."""
        perm = np.array([3, 2, 1, 0, 4])
        m = self.match_probs[np.ix_(perm, perm)]
        return StateMachineParams(
            self.t_match_continue, self.t_match_from_gap_x, self.t_match_from_gap_y,
            self.t_gap_open_x, self.t_gap_open_y, self.t_gap_extend_x,
            self.t_gap_extend_y, self.t_gap_switch_to_x, self.t_gap_switch_to_y,
            m, self.gap_x_probs[perm], self.gap_y_probs[perm])

    # convenience bundles for kernels
    def transition_vector(self) -> np.ndarray:
        """Order: [mm, m_from_gx, m_from_gy, open_x, open_y, ext_x, ext_y,
        switch_x, switch_y]."""
        return np.array([
            self.t_match_continue, self.t_match_from_gap_x, self.t_match_from_gap_y,
            self.t_gap_open_x, self.t_gap_open_y, self.t_gap_extend_x,
            self.t_gap_extend_y, self.t_gap_switch_to_x, self.t_gap_switch_to_y,
        ])


@dataclass
class RepeatSubMatrix:
    """log10-scale repeat-count substitution matrix.

    log_probs[base(strand-resolved), underlying, observed]; access semantics
    follow repeatSubMatrix.c:11-43: reverse strand uses base 3-b. Values are
    multiplied by 2.3025 when combined with natural-log emissions
    (stateMachine.c:736)."""
    log_probs: np.ndarray  # (4, 51, 51) float64, indexed [base, underlying, observed]
    base_log_probs_at: np.ndarray  # (51,)
    base_log_probs_gc: np.ndarray  # (51,)

    max_repeat = MAXIMUM_REPEAT_LENGTH

    def get(self, base: int, forward_strand: bool, observed: int, underlying: int) -> float:
        b = base if forward_strand else 3 - base
        if base >= 4:
            b = 0 if forward_strand else 3
        return float(self.log_probs[b, underlying, observed])

    @classmethod
    def empty(cls) -> "RepeatSubMatrix":
        n = MAXIMUM_REPEAT_LENGTH
        return cls(np.zeros((4, n, n)), np.zeros(n), np.zeros(n))

    def update_from_json(self, d: dict):
        """Merge a repeatCountSubstitutionMatrix block (parser.c:196-252;
        blocks from successive include levels merge into one matrix,
        parser.c:333-341).

        JSON keys: baseLogRepeatCounts_AT / _GC (priors) and
        repeatCountLogProbabilities_<base>_F — 51*51 forward-strand values
        laid out [underlying][observed] (parser.c:198-204); the reverse
        strand of base b reads the forward matrix of complement base 3-b
        (repeatSubMatrix.c:28-31)."""
        n = MAXIMUM_REPEAT_LENGTH
        for key, val in d.items():
            if key == "baseLogRepeatCounts_AT":
                self.base_log_probs_at = np.asarray(val, dtype=np.float64)
            elif key == "baseLogRepeatCounts_GC":
                self.base_log_probs_gc = np.asarray(val, dtype=np.float64)
            elif (key.startswith("repeatCountLogProbabilities_")
                  and len(key) == 31 and key[28] in "ACGT" and key[30] == "F"):
                b = "ACGT".index(key[28])
                self.log_probs[b] = np.asarray(val, dtype=np.float64).reshape(n, n)
            else:
                raise ValueError(f"Unrecognised key in repeat sub matrix json: {key}")


@dataclass
class PolishParams:
    """polish block (parser.c:253-290 defaults, :292-525 keys)."""
    useRunLengthEncoding: bool = True
    referenceBasePenalty: float = 0.5
    minPosteriorProbForAlignmentAnchors: np.ndarray = field(
        default_factory=lambda: np.array([0.9, 10.0]))
    includeSoftClipping: bool = False
    shuffleChunks: bool = True
    shuffleChunksMethod: str = "size_desc"
    useRepeatCountsInAlignment: bool = False
    chunkSize: int = 10000
    chunkBoundary: int = 1000
    maxDepth: int = 64
    excessiveDepthThreshold: int = 512
    includeSecondaryAlignments: bool = False
    includeSupplementaryAlignments: bool = False
    synchronizeSupplementaryAlignments: bool = False
    filterAlignmentsWithMapQBelowThisThreshold: int = 10
    candidateVariantWeight: float = 0.2
    columnAnchorTrim: int = 5
    maxConsensusStrings: int = 100
    useReadAlleles: bool = True
    useReadAllelesInPhasing: bool = False
    hetSubstitutionProbability: float = 0.0001
    hetRunLengthSubstitutionProbability: float = 0.0001
    poaConstructCompareRepeatCounts: bool = True
    maxPoaConsensusIterations: int = 0
    minPoaConsensusIterations: int = 0
    maxRealignmentPolishIterations: int = 1
    minRealignmentPolishIterations: int = 1
    filterReadsWhileHaveAtLeastThisCoverage: int = 0
    minAvgBaseQuality: float = 0.0
    skipHaploidPolishingIfDiploid: bool = False
    alphabet: str = "nucleotide"
    p: PairwiseAlignmentParameters = field(default_factory=PairwiseAlignmentParameters)
    # trained models
    sm_forward: Optional[StateMachineParams] = None   # read given ref, fwd strand
    sm_reverse: Optional[StateMachineParams] = None
    sm_genome_comparison: StateMachineParams = field(
        default_factory=StateMachineParams.default_nucleotide)
    repeat_sub_matrix: Optional[RepeatSubMatrix] = None

    _SIMPLE_KEYS = {
        "useRunLengthEncoding", "referenceBasePenalty", "includeSoftClipping",
        "shuffleChunks", "shuffleChunksMethod", "useRepeatCountsInAlignment",
        "chunkSize", "chunkBoundary", "maxDepth", "excessiveDepthThreshold",
        "includeSecondaryAlignments", "includeSupplementaryAlignments",
        "synchronizeSupplementaryAlignments",
        "filterAlignmentsWithMapQBelowThisThreshold", "candidateVariantWeight",
        "columnAnchorTrim", "maxConsensusStrings", "useReadAlleles",
        "useReadAllelesInPhasing", "hetSubstitutionProbability",
        "hetRunLengthSubstitutionProbability", "poaConstructCompareRepeatCounts",
        "maxPoaConsensusIterations", "minPoaConsensusIterations",
        "maxRealignmentPolishIterations", "minRealignmentPolishIterations",
        "filterReadsWhileHaveAtLeastThisCoverage", "minAvgBaseQuality",
        "skipHaploidPolishingIfDiploid", "alphabet",
    }

    def update_from_json(self, d: dict):
        for k, v in d.items():
            if k in self._SIMPLE_KEYS:
                cur = getattr(self, k)
                if isinstance(cur, bool):
                    setattr(self, k, bool(v))
                elif isinstance(cur, int):
                    setattr(self, k, int(v))
                elif isinstance(cur, float):
                    setattr(self, k, float(v))
                else:
                    setattr(self, k, v)
            elif k == "minPosteriorProbForAlignmentAnchors":
                arr = np.asarray(v, dtype=np.float64)
                if arr.size % 2 != 0:
                    raise ValueError("minPosteriorProbForAlignmentAnchors must have even length")
                self.minPosteriorProbForAlignmentAnchors = arr
            elif k == "pairwiseAlignmentParameters":
                self.p.update_from_json(v)
            elif k == "hmmForwardStrandReadGivenReference":
                self.sm_forward = StateMachineParams.from_hmm_json(v)
                self.sm_reverse = self.sm_forward.reverse_complement()
            elif k == "repeatCountSubstitutionMatrix":
                if self.repeat_sub_matrix is None:
                    self.repeat_sub_matrix = RepeatSubMatrix.empty()
                self.repeat_sub_matrix.update_from_json(v)
            else:
                raise ValueError(f"Unrecognised key in polish params json: {k}")

    def finish(self):
        """parser.c:495-525: validate; wire RLE emissions when
        useRepeatCountsInAlignment (handled in the kernel by passing the
        repeat matrix alongside the state machine)."""
        if self.sm_forward is None:
            raise ValueError("No HMM for read-to-reference alignment in polish params")
        if self.useRepeatCountsInAlignment:
            if not self.useRunLengthEncoding or self.repeat_sub_matrix is None:
                raise ValueError("useRepeatCountsInAlignment requires RLE + repeat matrix")


@dataclass
class PhaseParams:
    """phase block == stRPHmmParameters (parser.c:15-61 defaults,
    :110-188 keys)."""
    maxCoverageDepth: int = MAX_READ_PARTITIONING_DEPTH
    maxNotSumTransitions: bool = True
    minPartitionsInAColumn: int = 50
    maxPartitionsInAColumn: int = 200
    minPosteriorProbabilityForPartition: float = 0.001
    minReadCoverageToSupportPhasingBetweenHeterozygousSites: int = 0
    roundsOfIterativeRefinement: int = 0
    includeInvertedPartitions: bool = True
    minPhredScoreForHaplotypePartition: int = 0
    stitchWithPrimaryReadsOnly: bool = True
    includeHomozygousVCFEntries: bool = False
    onlyUsePassVCFEntries: bool = True
    onlyUseSNPVCFEntries: bool = False
    indelSizeForSVHandling: int = 0
    useSVsForPhasing: bool = False
    referenceExpansionForSmallVariants: int = 12
    referenceExpansionForStructuralVariants: int = 1024
    useVariantSelectionAdaptiveSampling: bool = True
    variantSelectionAdaptiveSamplingPrimaryThreshold: float = 0.9
    variantSelectionAdaptiveSamplingDesiredBasepairsPerVariant: int = 1000
    minSnpVariantQuality: float = 0
    minIndelVariantQuality: float = 0
    minSvVariantQuality: float = 0
    phasePrimaryVariantsOnly: bool = False
    updateAllOutputVCFFormatFields: bool = True
    phasesetMinBinomialReadSplitLikelihood: float = 0.0001
    phasesetMaxDiscordantRatio: float = 0.1
    phasesetMinSpanningReads: int = 1
    bubbleFindingIterations: int = 1
    bubbleMinBinomialStrandLikelihood: float = 0.05
    bubbleMinBinomialReadSplitLikelihood: float = 0.05

    def update_from_json(self, d: dict):
        known = {f.name for f in fields(self)}
        for k, v in d.items():
            if k not in known:
                raise ValueError(f"Unrecognised key in params file: {k}")
            cur = getattr(self, k)
            if isinstance(cur, bool):
                setattr(self, k, bool(v))
            elif isinstance(cur, int):
                setattr(self, k, int(v))
            else:
                setattr(self, k, float(v))


@dataclass
class Params:
    polish: PolishParams = field(default_factory=PolishParams)
    phase: PhaseParams = field(default_factory=PhaseParams)

    @staticmethod
    def load(path: str) -> "Params":
        """params_readParams (parser.c:643-650): recursive include chain then
        finishParsing."""
        params = Params()
        params._read(path)
        params.polish.finish()
        return params

    def _read(self, path: str):
        with open(path) as fh:
            doc = json.load(fh)
        for k, v in doc.items():
            if k == "include":
                nested = v if v.startswith("/") else os.path.join(os.path.dirname(path), v)
                self._read(os.path.normpath(nested))
            elif k == "polish":
                self.polish.update_from_json(v)
            elif k == "phase":
                self.phase.update_from_json(v)
            else:
                raise ValueError(f"Unrecognised key in params json: {k}")
