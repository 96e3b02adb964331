"""HELEN ML feature export: per-chunk POA summary images for the HELEN
polisher's RNN, written to HDF5.

Copy of `margin_tpu/polish/helen.py` with the port's imports; the truth
alignment's banded posteriors take the port's route (K2, or K3 for a
chunk-long truth). The image groups go through one writer interface, to
an HDF5 file (h5py) or to memory (HelenArrays).

Parity: impl/helenFeatures.c —
- simpleWeight features: PoaFeature_getSimpleWeightFeatures (:816-902),
  {A,C,G,T,gap} x {fwd,rev} summed observation weights per consensus
  position and insert position.
- splitRleWeight features: PoaFeature_getSplitRleWeightFeatures (:963-1036)
  + poa_addSplitRunLengthFeaturesForObservations (:905-960): weights binned
  by (symbol, run length 0..maxRL, strand), with run lengths beyond maxRL
  split into chained "run length position" rows.
- channelRleWeight features: PoaFeature_getChannelRleWeightFeatures
  (:1098-1172): separate nucleotide-count and run-length-count channels.
- truth labeling: annotateHelenFeaturesWithTruth (:1314-1551) walks the
  consensus-to-truth alignment assigning per-feature label characters and
  run lengths ('_' == gap == label 0).
- truth alignment: alignConsensusAndTruthRLEWithKmerAnchors (:1696-1753)
  (kmer anchors + banded aligned pairs + MEA), getConsensusByEstimated-
  OriginalReferencePositions (:746-805), calculateAlignIdentity (:437-511).
- HDF5 schema: writeSimpleWeightHelenFeaturesHDF5 (:2024-2232),
  writeSplitRleWeightHelenFeaturesHDF5 (:2235-2470),
  writeChannelRleWeightHelenFeaturesHDF5 (:2474-2752): groups
  `images/<base>.<i>` of exactly HDF5_FEATURE_SIZE rows (overlapping
  windows) with datasets contig/contig_start/contig_end/feature_chunk_idx/
  position/normalization/image (or nucleotide+runLengths)/label_base/
  label_run_length.

Index layout note: POS_STRAND_IDX == 1, NEG_STRAND_IDX == 0 (margin.h:126)
so the FORWARD strand takes the odd lane of each (symbol, strand) pair.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from margin_tpu_torch.alphabet import seq_to_symbols
from margin_tpu_torch.ops import banded
from margin_tpu_torch.params import Params
from margin_tpu_torch.polish.alignment import mea_alignment
from margin_tpu_torch.polish.kmers import get_kmer_alignment_anchors
from margin_tpu_torch.polish.poa import PAIR1, Poa, PoaRead
from margin_tpu_torch.rle import RleString

HDF5_FEATURE_SIZE = 1000  # helenFeatures.c:1940
MAX_TOTAL_WEIGHT = 256.0  # helenFeatures.c:2007
SYMBOL_NUMBER = 5
SYMBOL_NUMBER_NO_N = 4
POS_STRAND_IDX = 1  # margin.h:126
NEG_STRAND_IDX = 0  # margin.h:127
SPLIT_MAX_RUN_LENGTH_DEFAULT = 10  # margin.h:1572-1573

TRUTH_ALN_IDENTITY_THRESHOLD = 0.99  # helenFeatures.c:14
TRUTH_ALN_MIN_MATCHES = 700  # helenFeatures.c:15

SIMPLE_WEIGHT_TOTAL_SIZE = (SYMBOL_NUMBER_NO_N + 1) * 2


def _strand(forward: bool) -> int:
    return POS_STRAND_IDX if forward else NEG_STRAND_IDX


def simple_char_index(symbol: int, forward: bool) -> int:
    """PoaFeature_SimpleWeight_charIndex (helenFeatures.c:88-92)."""
    return symbol * 2 + _strand(forward)


def simple_gap_index(forward: bool) -> int:
    """PoaFeature_SimpleWeight_gapIndex (helenFeatures.c:94-98)."""
    return SYMBOL_NUMBER_NO_N * 2 + _strand(forward)


def split_char_index(max_rl: int, symbol: int, run_length: int,
                     forward: bool) -> int:
    """PoaFeature_SplitRleWeight_charIndex (helenFeatures.c:100-105)."""
    return (symbol * (max_rl + 1) + run_length) * 2 + _strand(forward)


def split_gap_index(max_rl: int, forward: bool) -> int:
    """PoaFeature_SplitRleWeight_gapIndex (helenFeatures.c:107-110)."""
    return (SYMBOL_NUMBER_NO_N * (max_rl + 1)) * 2 + _strand(forward)


def split_total_size(max_rl: int) -> int:
    return (SYMBOL_NUMBER_NO_N * (1 + max_rl) + 1) * 2


def channel_nucl_index(symbol: int, forward: bool) -> int:
    """PoaFeature_ChannelRleWeight_charNuclIndex (helenFeatures.c:112-115)."""
    return symbol * 2 + _strand(forward)


def channel_gap_nucl_index(forward: bool) -> int:
    """PoaFeature_ChannelRleWeight_gapNuclIndex (helenFeatures.c:117-120)."""
    return SYMBOL_NUMBER_NO_N * 2 + _strand(forward)


def channel_rl_index(max_rl: int, symbol: int, run_length: int,
                     forward: bool) -> int:
    """PoaFeature_ChannelRleWeight_charRLIndex (helenFeatures.c:122-127)."""
    return (symbol * (max_rl + 1) + run_length) * 2 + _strand(forward)


@dataclass
class SimpleWeightFeature:
    """PoaFeatureSimpleWeight (helenFeatures.h)."""
    ref_position: int
    insert_position: int
    weights: np.ndarray = field(
        default_factory=lambda: np.zeros(SIMPLE_WEIGHT_TOTAL_SIZE))
    label: str = "\0"
    next_insert: Optional["SimpleWeightFeature"] = None


@dataclass
class SplitRleWeightFeature:
    """PoaFeatureSplitRleWeight (helenFeatures.h)."""
    ref_position: int
    insert_position: int
    run_length_position: int
    max_run_length: int
    weights: np.ndarray = None
    label_char: str = "\0"
    label_run_length: int = 0
    next_run_length: Optional["SplitRleWeightFeature"] = None
    next_insert: Optional["SplitRleWeightFeature"] = None

    def __post_init__(self):
        if self.weights is None:
            self.weights = np.zeros(split_total_size(self.max_run_length))


@dataclass
class ChannelRleWeightFeature:
    """PoaFeatureChannelRleWeight (helenFeatures.h)."""
    ref_position: int
    insert_position: int
    run_length_position: int
    max_run_length: int
    nucleotide_weights: np.ndarray = None
    run_length_weights: np.ndarray = None
    label_char: str = "\0"
    label_run_length: int = 0
    next_run_length: Optional["ChannelRleWeightFeature"] = None
    next_insert: Optional["ChannelRleWeightFeature"] = None

    def __post_init__(self):
        if self.nucleotide_weights is None:
            self.nucleotide_weights = np.zeros(SYMBOL_NUMBER * 2)
        if self.run_length_weights is None:
            self.run_length_weights = np.zeros(
                SYMBOL_NUMBER_NO_N * (1 + self.max_run_length) * 2)


def _symbol_of(ch: str) -> int:
    return int(seq_to_symbols(ch)[0])


def get_simple_weight_features(poa: Poa, reads: List[PoaRead]
                               ) -> List[SimpleWeightFeature]:
    """PoaFeature_getSimpleWeightFeatures (helenFeatures.c:816-902)."""
    features = [SimpleWeightFeature(i, 0) for i in range(len(poa.nodes) - 1)]
    for i, feature in enumerate(features):
        node = poa.nodes[i + 1]  # first node is the leading 'N'
        for read_no, offset, weight in node.observations:
            read = reads[read_no]
            sym = _symbol_of(read.rle_read.bases[offset])
            feature.weights[simple_char_index(sym, read.forward_strand)] += weight
        for delete in node.deletes:
            for k in range(1, delete.length):
                if i + k >= len(features):
                    break
                features[i + k].weights[simple_gap_index(True)] += delete.weight_fwd
                features[i + k].weights[simple_gap_index(False)] += delete.weight_rev
        for insert in node.inserts:
            prev = feature
            for k, ch in enumerate(insert.insert.bases):
                cur = prev.next_insert
                if cur is None:
                    cur = SimpleWeightFeature(i, k + 1)
                    prev.next_insert = cur
                sym = _symbol_of(ch)
                cur.weights[simple_char_index(sym, True)] += insert.weight_fwd
                cur.weights[simple_char_index(sym, False)] += insert.weight_rev
                prev = cur
    return features


def _add_split_rl_observations(base_feature: SplitRleWeightFeature,
                               observations, reads: List[PoaRead],
                               max_rl: int, observation_offset: int) -> None:
    """poa_addSplitRunLengthFeaturesForObservations
    (helenFeatures.c:905-960)."""
    cur = base_feature
    rl_index = 0
    again = True
    while again:
        again = False
        for read_no, offset, weight in observations:
            read = reads[read_no]
            pos = offset + observation_offset
            sym = _symbol_of(read.rle_read.bases[pos])
            run_length = int(read.rle_read.counts[pos]) - rl_index * max_rl
            if run_length < 0:
                run_length = 0
            elif run_length > max_rl:
                run_length = max_rl
                again = True
            cur.weights[split_char_index(max_rl, sym, run_length,
                                         read.forward_strand)] += weight
        if again:
            rl_index += 1
            if cur.next_run_length is not None:
                cur = cur.next_run_length
            else:
                nxt = SplitRleWeightFeature(base_feature.ref_position,
                                            base_feature.insert_position,
                                            rl_index, max_rl)
                cur.next_run_length = nxt
                for fwd in (True, False):
                    nxt.weights[split_gap_index(max_rl, fwd)] = \
                        base_feature.weights[split_gap_index(max_rl, fwd)]
                cur = nxt


def get_split_rle_weight_features(poa: Poa, reads: List[PoaRead],
                                  max_rl: int) -> List[SplitRleWeightFeature]:
    """PoaFeature_getSplitRleWeightFeatures (helenFeatures.c:963-1036).

    Note: as in the reference, the insert loop does not advance its chain
    pointer, so every base of a multi-base insert accumulates into insert
    position 1 (helenFeatures.c:1016-1029 never updates prevFeature)."""
    features = [SplitRleWeightFeature(i, 0, 0, max_rl)
                for i in range(len(poa.nodes) - 1)]
    for i, feature in enumerate(features):
        node = poa.nodes[i + 1]
        _add_split_rl_observations(feature, node.observations, reads, max_rl, 0)
        for delete in node.deletes:
            for k in range(1, delete.length):
                if i + k >= len(features):
                    break
                features[i + k].weights[split_gap_index(max_rl, True)] += delete.weight_fwd
                features[i + k].weights[split_gap_index(max_rl, False)] += delete.weight_rev
        for insert in node.inserts:
            prev = feature
            for o in range(insert.insert.length):
                cur = prev.next_insert
                if cur is None:
                    cur = SplitRleWeightFeature(i, o + 1, 0, max_rl)
                    prev.next_insert = cur
                _add_split_rl_observations(cur, insert.observations, reads,
                                           max_rl, o)
    return features


def _add_channel_rl_observations(base_feature: ChannelRleWeightFeature,
                                 observations, reads: List[PoaRead],
                                 max_rl: int, observation_offset: int) -> None:
    """poa_addChannelRunLengthFeaturesForObservations
    (helenFeatures.c:1038-1096)."""
    cur = base_feature
    rl_index = 0
    again = True
    while again:
        again = False
        for read_no, offset, weight in observations:
            read = reads[read_no]
            pos = offset + observation_offset
            sym = _symbol_of(read.rle_read.bases[pos])
            run_length = int(read.rle_read.counts[pos]) - rl_index * max_rl
            if run_length < 0:
                run_length = 0
            elif run_length > max_rl:
                run_length = max_rl
                again = True
            fwd = read.forward_strand
            cur.nucleotide_weights[channel_nucl_index(sym, fwd)] += weight
            cur.run_length_weights[channel_rl_index(max_rl, sym, run_length,
                                                    fwd)] += weight
        if again:
            rl_index += 1
            if cur.next_run_length is not None:
                cur = cur.next_run_length
            else:
                nxt = ChannelRleWeightFeature(base_feature.ref_position,
                                              base_feature.insert_position,
                                              rl_index, max_rl)
                cur.next_run_length = nxt
                for fwd in (True, False):
                    nxt.nucleotide_weights[channel_gap_nucl_index(fwd)] = \
                        base_feature.nucleotide_weights[channel_gap_nucl_index(fwd)]
                cur = nxt


def get_channel_rle_weight_features(poa: Poa, reads: List[PoaRead],
                                    max_rl: int
                                    ) -> List[ChannelRleWeightFeature]:
    """PoaFeature_getChannelRleWeightFeatures (helenFeatures.c:1098-1172)."""
    features = [ChannelRleWeightFeature(i, 0, 0, max_rl)
                for i in range(len(poa.nodes) - 1)]
    for i, feature in enumerate(features):
        node = poa.nodes[i + 1]
        _add_channel_rl_observations(feature, node.observations, reads,
                                     max_rl, 0)
        for delete in node.deletes:
            for k in range(1, delete.length):
                if i + k >= len(features):
                    break
                features[i + k].nucleotide_weights[channel_gap_nucl_index(True)] += delete.weight_fwd
                features[i + k].nucleotide_weights[channel_gap_nucl_index(False)] += delete.weight_rev
        for insert in node.inserts:
            prev = feature
            for o in range(insert.insert.length):
                cur = prev.next_insert
                if cur is None:
                    cur = ChannelRleWeightFeature(i, o + 1, 0, max_rl)
                    prev.next_insert = cur
                _add_channel_rl_observations(cur, insert.observations, reads,
                                             max_rl, o)
    return features


# ---------------------------------------------------------------------------
# Truth labeling
# ---------------------------------------------------------------------------

def _set_label(feature, kind: str, char: str, truth_rl: int) -> None:
    if kind == "simple":
        feature.label = char
        return
    # split/channel: spread the true run length down the run-length chain
    rl = truth_rl
    f = feature
    while f is not None:
        f.label_char = char
        if rl <= 0:
            f.label_run_length = 0
        elif rl > f.max_run_length:
            f.label_run_length = f.max_run_length
        else:
            f.label_run_length = rl
        rl -= f.max_run_length
        f = f.next_run_length


def _set_gap_label(feature, kind: str) -> None:
    if kind == "simple":
        feature.label = "_"
        return
    f = feature
    while f is not None:
        f.label_char = "_"
        f.label_run_length = 0
        f = f.next_run_length


def annotate_features_with_truth(features: list, kind: str,
                                 true_ref_alignment: List[Tuple[int, int, int]],
                                 truth_rle: RleString
                                 ) -> Tuple[int, int]:
    """annotateHelenFeaturesWithTruth (helenFeatures.c:1314-1551).

    `true_ref_alignment` is a list of (consensusPos, truthPos, weight)
    tuples; returns (firstMatchedFeature, lastMatchedFeature)."""
    first, last = -1, -1
    aln_iter = iter(true_ref_alignment)
    curr = next(aln_iter, None)
    true_ref_pos = curr[1] if curr is not None else 0

    for feature_ref_pos, base in enumerate(features):
        feature = base
        feature_ins_pos = 0
        while feature is not None:
            if curr is None:
                # no more ref bases, everything is gaps
                _set_gap_label(feature, kind)
                feature = feature.next_insert
                continue
            if curr[0] == feature_ref_pos and curr[1] == true_ref_pos:
                # match
                _set_label(feature, kind, truth_rle.bases[true_ref_pos],
                           int(truth_rle.counts[true_ref_pos]))
                true_ref_pos += 1
                curr = next(aln_iter, None)
                if feature_ins_pos == 0:
                    if first == -1:
                        first = feature_ref_pos
                    last = feature_ref_pos
            elif true_ref_pos < curr[1]:
                # insert (truth base consumed against this feature)
                _set_label(feature, kind, truth_rle.bases[true_ref_pos],
                           int(truth_rle.counts[true_ref_pos]))
                true_ref_pos += 1
            elif feature_ref_pos < curr[0]:
                # delete (consensus base absent from truth)
                _set_gap_label(feature, kind)
            else:
                raise AssertionError(
                    "Unhandled case annotating features with truth")
            feature = feature.next_insert
            feature_ins_pos += 1
        # catch true inserts not present in the poa / feature list
        while (curr is not None and feature_ref_pos < curr[0]
               and true_ref_pos < curr[1]):
            true_ref_pos += 1
    return first, last


# ---------------------------------------------------------------------------
# Truth alignment
# ---------------------------------------------------------------------------

def align_consensus_and_truth(consensus: RleString, truth: RleString,
                              params: Params, tables,
                              use_lut: bool = False
                              ) -> Tuple[List[Tuple[int, int, int]], float]:
    """alignConsensusAndTruthRLEWithKmerAnchors (helenFeatures.c:1696-1753):
    kmer anchors + anchored banded aligned pairs + MEA, returned as
    (consensusPos, truthPos, weight) tuples."""
    pp = params.polish
    x_sym = consensus.symbols()
    y_sym = truth.symbols()
    anchors = get_kmer_alignment_anchors(x_sym, y_sym, pp.p.diagonalExpansion)
    min_len = min(consensus.length, truth.length)
    if min_len == 0 or len(anchors) / min_len < 0.2:
        return [], 0.0
    (matches, gapx, gapy), _total = banded.banded_posteriors(
        tables, x_sym, y_sym, anchors, pp.p.diagonalExpansion, strand=0,
        ragged_left=False, ragged_right=False, threshold=pp.p.threshold,
        dynamic=pp.p.dynamicAnchorExpansion,
        rep_x=consensus.counts if pp.useRunLengthEncoding else None,
        rep_y=truth.counts if pp.useRunLengthEncoding else None,
        use_lut=use_lut)
    mea, score = mea_alignment(np.asarray(matches, dtype=np.int64).reshape(-1, 3),
                               np.asarray(gapx, dtype=np.int64).reshape(-1, 3),
                               np.asarray(gapy, dtype=np.int64).reshape(-1, 3),
                               consensus.length, truth.length, pp.p.gapGamma)
    return [(int(x), int(y), int(w)) for w, x, y in mea], score


def calculate_align_identity(x_rle: RleString, y_rle: RleString,
                             pairs: List[Tuple[int, int, int]]) -> float:
    """calculateAlignIdentity (helenFeatures.c:437-511) in raw space."""
    if not pairs:
        return 0.0
    matches = mismatches = x_ins = y_ins = 0
    it = iter(pairs)
    curr = next(it, None)
    pos_x, pos_y = curr[0], curr[1]
    while curr is not None:
        cx, cy = curr[0], curr[1]
        if pos_x < cx:
            pos_x += 1
            x_ins += int(x_rle.counts[pos_x])
        elif pos_y < cy:
            pos_y += 1
            y_ins += int(y_rle.counts[pos_y])
        else:
            xr, yr = int(x_rle.counts[pos_x]), int(y_rle.counts[pos_y])
            if x_rle.bases[pos_x].lower() == y_rle.bases[pos_y].lower():
                if xr >= yr:
                    matches += yr
                    mismatches += xr - yr
                else:
                    matches += xr
                    mismatches += yr - xr
            else:
                if xr == yr:
                    mismatches += yr
                elif xr > yr:
                    mismatches += yr
                    x_ins += xr - yr
                else:
                    mismatches += xr
                    y_ins += yr - xr
            pos_x += 1
            pos_y += 1
            curr = next(it, None)
    denom = matches + mismatches + x_ins + y_ins
    return matches / denom if denom else 0.0


def get_consensus_by_estimated_positions(original_reference: RleString,
                                         consensus: RleString,
                                         rle_start: int, rle_end: int
                                         ) -> Tuple[RleString, int]:
    """getConsensusByEstimatedOriginalReferencePositions
    (helenFeatures.c:746-805). Returns (truncated consensus, shift)."""
    rle_map = original_reference.rle_to_non_rle_map()
    raw_start = int(rle_map[rle_start])
    raw_end = int(rle_map[rle_end])
    est_start = raw_start * consensus.non_rle_length // original_reference.non_rle_length
    est_end = raw_end * consensus.non_rle_length // original_reference.non_rle_length
    start_i, end_i = -1, -1
    pos = 0
    for i in range(consensus.length):
        if pos <= est_start:
            start_i = i
        if pos >= est_end:
            end_i = i
            break
        pos += int(consensus.counts[i])
    if end_i < 0:
        end_i = consensus.length
    assert start_i >= 0 and end_i >= start_i
    return consensus.substring(start_i, end_i - start_i), start_i


# ---------------------------------------------------------------------------
# Normalization + HDF5 output
# ---------------------------------------------------------------------------

def _cast_u8(v: float) -> int:
    # C (uint8_t) cast of a double: truncate toward zero, wrap mod 256.
    if not np.isfinite(v):
        return 0
    return int(v) & 0xFF


def total_weight_to_uint8(total_weight: float) -> int:
    """convertTotalWeightToUInt8 (helenFeatures.c:2009-2016)."""
    w = total_weight / PAIR1
    if w > MAX_TOTAL_WEIGHT:
        w = MAX_TOTAL_WEIGHT
    return _cast_u8(w / MAX_TOTAL_WEIGHT * 254)


def normalize_weight_to_uint8(total_weight: float, weight: float) -> int:
    """normalizeWeightToUInt8 (helenFeatures.c:2018-2021)."""
    if total_weight <= 0:
        return 0
    return _cast_u8(weight / total_weight * 254)


def _normalized_uint8(totals: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """normalize_weight_to_uint8 over a (rows, cols) array of weights with
    their rows' totals: the same float64 operations, in numpy."""
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        v = weights / totals[:, None] * 254
    ok = np.isfinite(v) & (totals[:, None] > 0)
    return (np.where(ok, np.trunc(np.where(ok, v, 0)), 0).astype(np.int64)
            & 0xFF).astype(np.uint8)


def _label_base_code(ch: str) -> int:
    """helenFeatures.c:2093-2095: symbol+1 for ACGT, 0 for anything else."""
    sym = _symbol_of(ch)
    return 0 if sym >= SYMBOL_NUMBER_NO_N else sym + 1


def _h5_windows(feature_count: int) -> Tuple[List[int], int]:
    """The reference's exactly-HDF5_FEATURE_SIZE-row window scheme
    (helenFeatures.c:2132-2146). Returns (start indices, window size)."""
    n_files = feature_count // HDF5_FEATURE_SIZE + \
        (0 if feature_count % HDF5_FEATURE_SIZE == 0 else 1)
    offset = 0
    if feature_count >= HDF5_FEATURE_SIZE:
        offset = (HDF5_FEATURE_SIZE * n_files - feature_count) // \
            (feature_count // HDF5_FEATURE_SIZE)
    starts = []
    for i in range(n_files):
        s = HDF5_FEATURE_SIZE * i - offset * i
        if i + 1 == n_files and feature_count >= HDF5_FEATURE_SIZE:
            s = feature_count - HDF5_FEATURE_SIZE
        starts.append(s)
    size = min(feature_count, HDF5_FEATURE_SIZE)
    return starts, size


class HelenArrays:
    """The image groups HelenHDF5File writes, kept in memory: `groups`
    maps "images/<base>.<i>" to its datasets, each a numpy array as it
    would be written (contig as a bytes array, the rest as the writers
    give them)."""

    def __init__(self):
        self.filename = None
        self.groups: dict = {}

    def close(self):
        pass

    def _write_group(self, base_name: str, file_idx: int, chunk,
                     datasets: dict):
        self.groups[f"images/{base_name}.{file_idx}"] = dict(
            _group_header(chunk, file_idx), **datasets)

    def write_windows(self, base_name: str, chunk, count: int,
                      arrays: dict) -> int:
        starts, size = _h5_windows(count)
        for file_idx, s in enumerate(starts):
            self._write_group(base_name, file_idx, chunk,
                              {k: a[s:s + size] for k, a in arrays.items()})
        return len(starts)


def _group_header(chunk, file_idx: int) -> dict:
    """The datasets every image group starts with (helenFeatures.c:
    2148-2176): contig name, chunk bounds and the window's index."""
    return {"contig": np.array([chunk.ref_name.encode()]),
            "contig_start": np.array([chunk.chunk_overlap_start],
                                     dtype=np.uint32),
            "contig_end": np.array([chunk.chunk_overlap_end],
                                   dtype=np.uint32),
            "feature_chunk_idx": np.array([file_idx], dtype=np.uint32)}


class HelenHDF5File(HelenArrays):
    """HelenFeatureHDF5FileInfo (helenFeatures.c:2754-2780) via h5py.
    Note the reference's "int64Type" is actually a uint32 — kept."""

    def __init__(self, filename: str):
        super().__init__()
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                "HELEN feature output (-f) writes HDF5 through the h5py "
                "package, which is not installed") from e
        self.filename = filename
        self.file = h5py.File(filename, "w")

    def close(self):
        self.file.close()

    def _write_group(self, base_name: str, file_idx: int, chunk,
                     datasets: dict):
        import h5py
        grp = self.file.create_group(f"images/{base_name}.{file_idx}")
        name = chunk.ref_name
        st = h5py.string_dtype(encoding="ascii", length=len(name) + 1)
        for key, arr in dict(_group_header(chunk, file_idx),
                             **datasets).items():
            grp.create_dataset(key, data=(np.array([name.encode()], dtype=st)
                                          if key == "contig" else arr))


def _flatten_simple(features, first, last):
    out = []
    for i in range(first, last + 1):
        base = features[i]
        total = float(base.weights.sum())
        f = base
        while f is not None:
            out.append((f, total))
            f = f.next_insert
    return out


def _flatten_rl(features, first, last, total_of):
    out = []
    for i in range(first, last + 1):
        base = features[i]
        total = total_of(base)
        ins = base
        while ins is not None:
            rl = ins
            while rl is not None:
                out.append((rl, total))
                rl = rl.next_run_length
            ins = ins.next_insert
    return out


def write_simple_weight_features_h5(h5: HelenHDF5File, base_name: str,
                                    chunk, output_labels: bool,
                                    features, first: int, last: int) -> int:
    """writeSimpleWeightHelenFeaturesHDF5 (helenFeatures.c:2024-2232)."""
    flat = _flatten_simple(features, first, last)
    n = len(flat)
    if n < HDF5_FEATURE_SIZE and output_labels:
        return 0
    position = np.zeros((n, 2), dtype=np.uint32)
    normalization = np.zeros((n, 1), dtype=np.uint8)
    image = np.zeros((n, SIMPLE_WEIGHT_TOTAL_SIZE), dtype=np.uint8)
    label_base = np.zeros((n, 1), dtype=np.uint8)
    for k, (f, total) in enumerate(flat):
        position[k] = (f.ref_position, f.insert_position)
        normalization[k, 0] = total_weight_to_uint8(total)
        if output_labels:
            label_base[k, 0] = _label_base_code(f.label)
    if n:
        image[:] = _normalized_uint8(np.array([t for _, t in flat]),
                                     np.stack([f.weights for f, _ in flat]))
    arrays = {"position": position, "normalization": normalization,
              "image": image}
    if output_labels:
        arrays["label_base"] = label_base
    return h5.write_windows(base_name, chunk, n, arrays)


def write_split_rle_weight_features_h5(h5: HelenHDF5File, base_name: str,
                                       chunk, output_labels: bool,
                                       features, first: int, last: int,
                                       max_rl: int) -> int:
    """writeSplitRleWeightHelenFeaturesHDF5 (helenFeatures.c:2235-2470)."""
    cols = split_total_size(max_rl)
    flat = _flatten_rl(features, first, last,
                       lambda b: float(b.weights.sum()))
    n = len(flat)
    if n < HDF5_FEATURE_SIZE and output_labels:
        return 0
    position = np.zeros((n, 3), dtype=np.uint32)
    normalization = np.zeros((n, 1), dtype=np.uint8)
    image = np.zeros((n, cols), dtype=np.uint8)
    label_base = np.zeros((n, 1), dtype=np.uint8)
    label_rl = np.zeros((n, 1), dtype=np.uint8)
    for k, (f, total) in enumerate(flat):
        position[k] = (f.ref_position, f.insert_position,
                       f.run_length_position)
        normalization[k, 0] = total_weight_to_uint8(total)
        if output_labels:
            code = _label_base_code(f.label_char)
            label_base[k, 0] = code
            label_rl[k, 0] = 0 if code == 0 else f.label_run_length
    if n:
        image[:] = _normalized_uint8(np.array([t for _, t in flat]),
                                     np.stack([f.weights for f, _ in flat]))
    arrays = {"position": position, "normalization": normalization,
              "image": image}
    if output_labels:
        arrays["label_base"] = label_base
        arrays["label_run_length"] = label_rl
    return h5.write_windows(base_name, chunk, n, arrays)


def write_channel_rle_weight_features_h5(h5: HelenHDF5File, base_name: str,
                                         chunk, output_labels: bool,
                                         features, first: int, last: int,
                                         max_rl: int) -> int:
    """writeChannelRleWeightHelenFeaturesHDF5 (helenFeatures.c:2474-2752)."""
    nucl_cols = SYMBOL_NUMBER * 2
    rl_cols = (max_rl + 1) * 2
    flat = _flatten_rl(features, first, last,
                       lambda b: float(b.nucleotide_weights.sum()))
    n = len(flat)
    if n < HDF5_FEATURE_SIZE and output_labels:
        return 0
    position = np.zeros((n, 3), dtype=np.uint32)
    normalization = np.zeros((n, 1), dtype=np.uint8)
    nucleotide = np.zeros((n, nucl_cols), dtype=np.uint8)
    run_lengths = np.zeros((n, rl_cols, SYMBOL_NUMBER - 1), dtype=np.uint8)
    label_base = np.zeros((n, 1), dtype=np.uint8)
    label_rl = np.zeros((n, 1), dtype=np.uint8)
    for k, (f, total) in enumerate(flat):
        position[k] = (f.ref_position, f.insert_position,
                       f.run_length_position)
        normalization[k, 0] = total_weight_to_uint8(total)
        for c in range(SYMBOL_NUMBER - 1):
            for fwd in (True, False):
                nucleotide[k, c * 2 + _strand(fwd)] = normalize_weight_to_uint8(
                    total, f.nucleotide_weights[channel_nucl_index(c, fwd)])
                for r in range(max_rl + 1):
                    run_lengths[k, r * 2 + _strand(fwd), c] = \
                        normalize_weight_to_uint8(
                            total, f.run_length_weights[
                                channel_rl_index(max_rl, c, r, fwd)])
        for fwd in (True, False):
            nucleotide[k, SYMBOL_NUMBER_NO_N * 2 + _strand(fwd)] = \
                normalize_weight_to_uint8(
                    total, f.nucleotide_weights[channel_gap_nucl_index(fwd)])
        if output_labels:
            code = _label_base_code(f.label_char)
            label_base[k, 0] = code
            label_rl[k, 0] = 0 if code == 0 else f.label_run_length
    arrays = {"position": position, "normalization": normalization,
              "nucleotide": nucleotide, "runLengths": run_lengths}
    if output_labels:
        arrays["label_base"] = label_base
        arrays["label_run_length"] = label_rl
    return h5.write_windows(base_name, chunk, n, arrays)


# ---------------------------------------------------------------------------
# Per-chunk driver hook
# ---------------------------------------------------------------------------

_FEATURE_PREFIX = {"simpleWeight": "simpleWeight",
                   "splitRleWeight": "splitRleWeight",
                   "channelRleWeight": "channelRleWeight"}


def normalize_feature_type(name: str) -> str:
    """polish.c:195-207 featureType aliases."""
    low = name.lower()
    if low in ("simpleweight", "simple"):
        return "simpleWeight"
    if low in ("rleweight", "splitrleweight", "split"):
        return "splitRleWeight"
    if low in ("channelrleweight", "channel"):
        return "channelRleWeight"
    raise ValueError(f"Unrecognized featureType for HELEN: {name}")


def get_truth_alignment(chunk, true_reference_bam: str,
                        original_ref_rle: RleString,
                        consensus_rle: RleString, params: Params, tables,
                        use_lut: bool = False, log=print
                        ) -> Tuple[Optional[list], Optional[RleString]]:
    """The truth-extraction half of PoaFeature_handleHelenFeatures
    (helenFeatures.c:164-243): pull the truth contig aligned over this
    chunk from `true_reference_bam`, align it to the polished consensus,
    and accept only high-identity alignments."""
    from margin_tpu_torch.io import bam as bamio
    from margin_tpu_torch.polish.reads import convert_to_reads_and_alignments

    truth_reader = bamio.open_alignment(true_reference_bam)
    try:
        reads, alns, _f, _fa = convert_to_reads_and_alignments(
            chunk, original_ref_rle, truth_reader, params.polish,
            keep_filtered=False)
    finally:
        truth_reader.close()
    if len(reads) != 1:
        log(f"  helen: got {len(reads)} truth alignments for chunk "
            f"{chunk.chunk_idx}, need exactly 1")
        return None, None
    truth_rle = reads[0].rle_read
    truth_aln = alns[0]
    if len(truth_aln) == 0:
        return None, None
    rle_start = int(truth_aln[0][0])
    rle_end = int(truth_aln[-1][0])
    consensus_region, shift = get_consensus_by_estimated_positions(
        original_ref_rle, consensus_rle, rle_start, rle_end)
    pairs, _score = align_consensus_and_truth(consensus_region, truth_rle,
                                              params, tables, use_lut)
    pairs = [(x + shift, y, w) for x, y, w in pairs]
    if len(pairs) <= TRUTH_ALN_MIN_MATCHES:
        log(f"  helen: truth alignment failed with {len(pairs)} matches")
        return None, None
    pairs = pairs[10:-10]  # trim edges (helenFeatures.c:211-212)
    identity = calculate_align_identity(consensus_rle, truth_rle, pairs)
    if identity < TRUTH_ALN_IDENTITY_THRESHOLD:
        log(f"  helen: truth alignment identity {identity:.4f} < "
            f"{TRUTH_ALN_IDENTITY_THRESHOLD}, skipping")
        return None, None
    return pairs, truth_rle


def handle_helen_features(feature_type: str, max_rl: int, h5: HelenHDF5File,
                          full_feature_output: bool,
                          true_reference_bam: Optional[str],
                          original_ref_rle: RleString, params: Params,
                          chunk_idx: int, chunk, poa: Poa,
                          reads: List[PoaRead], tables,
                          use_lut: bool = False, log=print) -> int:
    """PoaFeature_handleHelenFeatures (helenFeatures.c:129-277). Returns
    the number of image groups written."""
    base_name = (f"{_FEATURE_PREFIX[feature_type]}.C{chunk_idx:05d}."
                 f"{chunk.ref_name}-{chunk.chunk_overlap_start}-"
                 f"{chunk.chunk_overlap_end}")
    consensus_rle = poa.ref_string

    truth_pairs = truth_rle = None
    if true_reference_bam is not None:
        truth_pairs, truth_rle = get_truth_alignment(
            chunk, true_reference_bam, original_ref_rle, consensus_rle,
            params, tables, use_lut, log)
        if truth_pairs is None:
            log(f"  helen: no valid reference alignment for chunk "
                f"{chunk_idx}, skipping feature output")
            return 0
    output_labels = truth_pairs is not None

    if feature_type == "simpleWeight":
        features = get_simple_weight_features(poa, reads)
        first, last = 0, len(features) - 1
        if output_labels:
            first, last = annotate_features_with_truth(
                features, "simple", truth_pairs, truth_rle)
        n = write_simple_weight_features_h5(h5, base_name, chunk,
                                            output_labels, features,
                                            first, last)
    elif feature_type == "splitRleWeight":
        features = get_split_rle_weight_features(poa, reads, max_rl)
        first, last = 0, len(features) - 1
        if output_labels:
            first, last = annotate_features_with_truth(
                features, "split", truth_pairs, truth_rle)
        n = write_split_rle_weight_features_h5(h5, base_name, chunk,
                                               output_labels, features,
                                               first, last, max_rl)
    elif feature_type == "channelRleWeight":
        features = get_channel_rle_weight_features(poa, reads, max_rl)
        first, last = 0, len(features) - 1
        if output_labels:
            first, last = annotate_features_with_truth(
                features, "channel", truth_pairs, truth_rle)
        n = write_channel_rle_weight_features_h5(h5, base_name, chunk,
                                                 output_labels, features,
                                                 first, last, max_rl)
    else:
        raise ValueError(f"Unhandled HELEN feature type: {feature_type}")

    if full_feature_output:
        from margin_tpu_torch.io.fasta import write_fasta
        contig = (f"{chunk.ref_name}\t{chunk.chunk_overlap_start}\t"
                  f"{chunk.chunk_overlap_end}\t{base_name}")
        write_fasta(f"{base_name}.fa", [(contig, consensus_rle.expand())])
    return n
