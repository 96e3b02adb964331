"""Bubble graph construction from VCF + read substrings, with allele-read
supports computed by the batched pair-HMM device kernel.

Parity: bubbleGraph_constructFromVCFAndBamChunkReadVcfEntrySubstrings
(bubbleGraph.c:1338-1497) and buildVcfEntryToReadSubstringsMap
(bubbleGraph.c:1281-1323); bubbleGraph_getReference (bubbleGraph.c:2446-2474)
and bubbleGraph_getProfileSeqs (bubbleGraph.c:2356-2444).

TPU design: the reference scores each (read substring x allele) pair with a
scalar banded DP call (its hot loop #1). Here every pair in the whole chunk
becomes one lane of a single `pairhmm.forward_total` batch — identical math
(empty anchor band == dense rectangle), three orders of magnitude fewer
kernel launches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from margin_tpu_torch.alphabet import seq_to_symbols
from margin_tpu_torch.io.vcf import VcfEntry
from margin_tpu_torch.ops import pairhmm
from margin_tpu_torch.params import Params
from margin_tpu_torch.rle import RleString
from margin_tpu_torch.phase.readextract import ReadVcfSubstrings
from margin_tpu_torch.utils import profiling

PROFILE_PROB_SCALAR = 30.0  # margin.h:189


@dataclass
class ReadSubstring:
    """BamChunkReadSubstring (bubbleGraph.c:1293-1310)."""
    read: ReadVcfSubstrings
    rle_string: RleString
    qual_value: float


@dataclass
class Bubble:
    ref_start: int
    bubble_length: int
    variant_position: int  # POA-space position of the variant
    root_vcf_entry: VcfEntry
    ref_allele: RleString
    reads: List[ReadSubstring]
    alleles: List[RleString]
    allele_read_supports: np.ndarray  # float32 (alleleNo, readNo)
    allele_offset: int = 0


@dataclass
class BubbleGraph:
    bubbles: List[Bubble]

    def __post_init__(self):
        offset = 0
        for b in self.bubbles:
            b.allele_offset = offset
            offset += len(b.alleles)
        self.total_alleles = offset


@dataclass
class Site:
    """stSite (margin.h): per-bubble allele count + substitution costs."""
    allele_number: int
    allele_offset: int
    allele_prior_log_probs: np.ndarray  # uint16
    substitution_log_probs: np.ndarray  # uint16 (A, A)


@dataclass
class Reference:
    """stReference over bubbles (bubbleGraph_getReference)."""
    name: str
    sites: List[Site]
    total_alleles: int

    @property
    def length(self):
        return len(self.sites)

    def allele_offsets(self) -> np.ndarray:
        return np.array([s.allele_offset for s in self.sites] + [self.total_alleles])


@dataclass
class ProfileSeq:
    """stProfileSeq: per-read normalized allele -log probs (uint8, scaled by
    PROFILE_PROB_SCALAR) over its covered bubbles."""
    read: ReadVcfSubstrings
    read_id: str
    ref_start: int  # first bubble index
    length: int     # in bubbles
    allele_offset: int
    probs: np.ndarray  # uint8 over alleles in covered range

    def site_probs(self, ref: Reference, site_idx: int) -> np.ndarray:
        s = ref.sites[site_idx]
        off = s.allele_offset - self.allele_offset
        return self.probs[off:off + s.allele_number]


def _qual_value(quals: Optional[np.ndarray]) -> float:
    # bubbleGraph.c:1301-1310 ('qualities[0] != 0' quirk preserved)
    if quals is None or len(quals) == 0 or quals[0] == 0:
        return -1.0
    return float(np.asarray(quals, dtype=np.int64).sum()) / len(quals)


def build_bubble_graph(reads: List[ReadVcfSubstrings], vcf_entries: List[VcfEntry],
                       params: Params, tables: pairhmm.PairHmmTables,
                       batch_max: int = 32768,
                       use_lut: bool = False) -> Tuple[BubbleGraph, List[VcfEntry]]:
    """Returns (bubble_graph, vcf_entries_to_bubbles)."""
    use_rle = params.polish.useRunLengthEncoding

    # vcfEntry -> list of ReadSubstring in read order (bubbleGraph.c:1281-1323)
    entry_to_subs: Dict[int, List[ReadSubstring]] = {}
    for r in reads:
        for entry, sub, quals in zip(r.vcf_entries, r.substrings, r.qualities):
            rs = ReadSubstring(
                r,
                RleString.encode(sub) if use_rle else RleString.identity(sub),
                _qual_value(quals))
            entry_to_subs.setdefault(id(entry), []).append(rs)

    bubbles: List[Bubble] = []
    entries_to_bubbles: List[VcfEntry] = []
    # batched scoring bookkeeping
    pending_pairs = []       # (x_sym, y_sym) sequences
    pending_strands = []
    pending_reps = []        # (rep_x, rep_y)
    pending_slots = []       # (bubble_idx, allele_idx, read_idx)

    for entry in vcf_entries:
        subs = entry_to_subs.get(id(entry))
        if not subs:
            continue
        alleles = [a.copy() for a in entry.allele_substrings]
        # reads are popped from the end of the list (bubbleGraph.c:1394-1396)
        bubble_reads = list(reversed(subs))
        n_read, n_allele = len(bubble_reads), len(alleles)
        b = Bubble(entry.ref_aln_start,
                   entry.ref_aln_stop_incl - entry.ref_aln_start,
                   entry.ref_pos, entry,
                   alleles[0].copy(), bubble_reads, alleles,
                   np.zeros((n_allele, n_read), dtype=np.float32))
        bidx = len(bubbles)
        bubbles.append(b)
        entries_to_bubbles.append(entry)

        allele_syms = [a.symbols() for a in alleles]
        allele_reps = [np.minimum(a.counts, 50) for a in alleles] if use_rle else None

        # dedupe identical read substrings (bubbleGraph.c:1418-1441 cache)
        seen: Dict[str, int] = {}
        b._dup_of = np.arange(n_read)
        for k, rs in enumerate(bubble_reads):
            key = rs.rle_string.expand()
            if key in seen:
                b._dup_of[k] = seen[key]
                continue
            seen[key] = k
            y_sym = rs.rle_string.symbols()
            y_rep = np.minimum(rs.rle_string.counts, 50) if use_rle else None
            strand = 0 if rs.read.forward_strand else 1
            for j in range(n_allele):
                pending_pairs.append((allele_syms[j], y_sym))
                pending_strands.append(strand)
                if use_rle:
                    pending_reps.append((allele_reps[j], y_rep))
                pending_slots.append((bidx, j, k))

    # score all pending pairs in padded batches
    _score_pending(bubbles, pending_pairs, pending_strands, pending_reps,
                   pending_slots, tables, use_rle, batch_max, use_lut,
                   sv_limit=params.phase.referenceExpansionForStructuralVariants,
                   expansion=params.polish.p.diagonalExpansion)

    # propagate cached duplicates
    for b in bubbles:
        dup = b._dup_of
        for k in range(len(b.reads)):
            if dup[k] != k:
                b.allele_read_supports[:, k] = b.allele_read_supports[:, dup[k]]
        del b._dup_of

    return BubbleGraph(bubbles), entries_to_bubbles


def score_sv_pairs(tables, pairs, strands, reps, owners, use_rle,
                   sv_limit: int, expansion: int, use_lut: bool = False):
    """Scores the SV-length pairs (either side longer than `sv_limit`) with
    the kmer-anchored banded kernel instead of the dense batch
    (bubbleGraph.c:1447-1453), so they don't inflate the dense batches: one
    batched solve (funnel/IPC-routed) for all of them, threshold 2.0 =
    totals only, no pair extraction. Returns ([(owner, total)] of the SV
    pairs, then pairs, strands, reps and owners of the others), each in
    the order given; with no SV pair (or sv_limit <= 0) the lists given."""
    sv_idx = [i for i, (x_sym, y_sym) in enumerate(pairs)
              if len(x_sym) > sv_limit or len(y_sym) > sv_limit] \
        if sv_limit > 0 else []
    if not sv_idx:
        return [], pairs, strands, reps, owners
    from margin_tpu_torch.ops import banded
    from margin_tpu_torch.polish.kmers import get_kmer_alignment_anchors
    with profiling.span("phase.sv_score", len(sv_idx)):
        with profiling.span("phase.sv_anchors", len(sv_idx)):
            items = []
            for i in sv_idx:
                x_sym, y_sym = pairs[i]
                it = {"x_sym": x_sym, "y_sym": y_sym,
                      "anchors": get_kmer_alignment_anchors(x_sym, y_sym,
                                                            expansion),
                      "strand": strands[i]}
                if use_rle:
                    it["rep_x"] = reps[i][0]
                    it["rep_y"] = reps[i][1]
                items.append(it)
        res = banded.banded_posteriors_many(
            tables, items, expansion, threshold=2.0, use_lut=use_lut)
    gone = set(sv_idx)

    def rest(seq):
        return [v for i, v in enumerate(seq) if i not in gone]
    return ([(owners[i], total) for i, (_pairs, total) in zip(sv_idx, res)],
            rest(pairs), rest(strands), rest(reps), rest(owners))


def _score_pending(bubbles, pairs, strands, reps, slots, tables, use_rle,
                   batch_max, use_lut, sv_limit: int = 0, expansion: int = 20):
    scored, pairs, strands, reps, slots = score_sv_pairs(
        tables, pairs, strands, reps, slots, use_rle, sv_limit, expansion,
        use_lut)
    for (bidx, j, k), total in scored:
        bubbles[bidx].allele_read_supports[j, k] = total
    if not pairs:
        return
    from margin_tpu_torch.parallel import executor
    scores = executor.score_pairs(tables, pairs, strands,
                                  rep_pairs=reps if use_rle else None,
                                  use_lut=use_lut, batch_max=batch_max)
    for (bidx, j, k), s in zip(slots, scores):
        bubbles[bidx].allele_read_supports[j, k] = s


def get_reference(bg: BubbleGraph, ref_name: str, params: Params) -> Reference:
    """bubbleGraph_getReference (bubbleGraph.c:2446-2474). The substitution
    cost is round(-log(hetSubstitutionProbability)*30) stored as uint16; the
    reference's C cast of +inf (hetSubstitutionProbability == 0, the shipped
    base_params value) lands on 0, which we reproduce deliberately: it makes
    the ancestor-substitution machinery a no-op."""
    p = params.polish.hetSubstitutionProbability
    if p <= 0:
        sub_cost = 0
    else:
        sub_cost = int(math.floor(-math.log(p) * PROFILE_PROB_SCALAR + 0.5)) & 0xFFFF
    sites = []
    for b in bg.bubbles:
        n = len(b.alleles)
        subs = np.full((n, n), sub_cost, dtype=np.uint16)
        np.fill_diagonal(subs, 0)
        sites.append(Site(n, b.allele_offset, np.zeros(n, dtype=np.uint16), subs))
    return Reference(ref_name, sites, bg.total_alleles)


def get_profile_seqs(bg: BubbleGraph, ref: Reference) -> Dict[int, ProfileSeq]:
    """bubbleGraph_getProfileSeqs (bubbleGraph.c:2356-2444). Returns map
    id(read) -> ProfileSeq."""
    # last bubble index per read
    read_ends: Dict[int, int] = {}
    read_objs: Dict[int, ReadVcfSubstrings] = {}
    for i, b in enumerate(bg.bubbles):
        for rs in b.reads:
            read_ends[id(rs.read)] = i
            read_objs[id(rs.read)] = rs.read

    offsets = ref.allele_offsets()
    pseqs: Dict[int, ProfileSeq] = {}
    for i, b in enumerate(bg.bubbles):
        n_read = len(b.reads)
        n_allele = len(b.alleles)
        for j, rs in enumerate(b.reads):
            key = id(rs.read)
            ps = pseqs.get(key)
            if ps is None:
                length = read_ends[key] - i + 1
                a_off = int(offsets[i])
                n_alleles_covered = int(offsets[i + length]) - a_off
                ps = ProfileSeq(rs.read, rs.read.read_name, i, length, a_off,
                                np.zeros(n_alleles_covered, dtype=np.uint8))
                pseqs[key] = ps
            # normalize supports for this read at this bubble
            supports = b.allele_read_supports[:, j].astype(np.float64)
            total = _log_sum_exp(supports)
            scaled = PROFILE_PROB_SCALAR * (total - supports)
            vals = np.floor(scaled + 0.5)  # roundf: half away from zero (>=0 here)
            vals = np.minimum(vals, 255).astype(np.uint8)
            off = b.allele_offset - ps.allele_offset
            ps.probs[off:off + n_allele] = vals
    return pseqs


def _log_sum_exp(a: np.ndarray) -> float:
    m = np.max(a)
    if np.isneginf(m):
        return float("-inf")
    return float(m + np.log(np.exp(a - m).sum()))
