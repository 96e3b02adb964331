"""Genome fragment: per-site genotype/haplotype calls from an HMM path,
iterative refinement, and final read->haplotype assignment.

Parity: impl/genomeFragment.c, impl/emissions.c:246-343.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set

import numpy as np

from margin_tpu_torch.phase.bubbles import ProfileSeq, Reference, PROFILE_PROB_SCALAR
from margin_tpu_torch.phase.rphmm import RPHmm


@dataclass
class GenomeFragment:
    """stGenomeFragment (margin.h:482-516)."""
    reference: Reference
    ref_start: int
    length: int
    reads1: Set[int] = field(default_factory=set)  # id(ProfileSeq)
    reads2: Set[int] = field(default_factory=set)
    pseq_by_id: Dict[int, ProfileSeq] = field(default_factory=dict)
    genotype_string: np.ndarray = None
    genotype_probs: np.ndarray = None
    haplotype_string1: np.ndarray = None
    haplotype_string2: np.ndarray = None
    ancestor_string: np.ndarray = None
    haplotype_probs1: np.ndarray = None
    haplotype_probs2: np.ndarray = None
    reads_supporting_hap1: np.ndarray = None
    reads_supporting_hap2: np.ndarray = None

    def __post_init__(self):
        n = self.length
        self.genotype_string = np.zeros(n, dtype=np.int64)
        self.genotype_probs = np.zeros(n, dtype=np.float32)
        self.haplotype_string1 = np.zeros(n, dtype=np.int64)
        self.haplotype_string2 = np.zeros(n, dtype=np.int64)
        self.ancestor_string = np.zeros(n, dtype=np.int64)
        self.haplotype_probs1 = np.zeros(n, dtype=np.float32)
        self.haplotype_probs2 = np.zeros(n, dtype=np.float32)
        self.reads_supporting_hap1 = np.zeros(n, dtype=np.int64)
        self.reads_supporting_hap2 = np.zeros(n, dtype=np.int64)


def _site_profile_matrix(ref: Reference, col, a0: int, a1: int) -> np.ndarray:
    P = np.zeros((col.depth, a1 - a0), dtype=np.int64)
    for i, ps in enumerate(col.seqs):
        P[i] = ps.probs[a0 - ps.allele_offset:a1 - ps.allele_offset]
    return P


def fill_in_predicted_genome(gf: GenomeFragment, partition: int, col,
                             ref: Reference):
    """fillInPredictedGenome (emissions.c:262-343) for all sites of one
    column/partition."""
    offsets = ref.allele_offsets()
    a0 = int(offsets[col.ref_start])
    a1 = int(offsets[col.ref_start + col.length])
    d = col.depth
    P = _site_profile_matrix(ref, col, a0, a1)
    member = np.array([(partition >> i) & 1 for i in range(d)], dtype=np.int64)
    s1 = member @ P
    s2 = (1 - member) @ P
    n_in = int(member.sum())
    for s in range(col.ref_start, col.ref_start + col.length):
        site = ref.sites[s]
        off = site.allele_offset - a0
        a = site.allele_number
        h1 = s1[off:off + a]
        h2 = s2[off:off + a]
        sub = site.substitution_log_probs.astype(np.int64)
        prior = site.allele_prior_log_probs.astype(np.int64)
        anc1 = (h1[None, :] + sub).min(axis=1)  # (A,)
        anc2 = (h2[None, :] + sub).min(axis=1)
        tot = anc1 + anc2 + prior
        ancestor = int(np.argmin(tot))  # first min (strict <, emissions.c:289-297)
        hap1 = int(np.argmin(h1 + sub[ancestor]))
        hap2 = int(np.argmin(h2 + sub[ancestor]))
        k = s - gf.ref_start
        gf.ancestor_string[k] = ancestor
        gf.haplotype_string1[k] = hap1
        gf.haplotype_string2[k] = hap2
        gf.genotype_string[k] = (hap1 * a + hap2 if hap1 < hap2
                                 else hap2 * a + hap1)
        gf.genotype_probs[k] = -float(tot[ancestor])
        gf.haplotype_probs1[k] = -float(h1[hap1])
        gf.haplotype_probs2[k] = -float(h2[hap2])
        gf.reads_supporting_hap1[k] = n_in
        gf.reads_supporting_hap2[k] = d - n_in


def construct_genome_fragment(hmm: RPHmm, path: List[int]) -> GenomeFragment:
    """stGenomeFragment_construct (genomeFragment.c:40-69)."""
    gf = GenomeFragment(hmm.ref, hmm.ref_start, hmm.ref_length)
    # partition reads by path (stRPHmm_partitionSequencesByStatePath, hmm.c:221-248)
    for col, part in zip(hmm.columns, path):
        for i, ps in enumerate(col.seqs):
            gf.pseq_by_id[id(ps)] = ps
            if (part >> i) & 1:
                gf.reads1.add(id(ps))
            else:
                gf.reads2.add(id(ps))
    for col, part in zip(hmm.columns, path):
        fill_in_predicted_genome(gf, part, col, hmm.ref)
    return gf


def log_prob_of_read_given_haplotype(hap_string: np.ndarray, start: int,
                                     length: int, ps: ProfileSeq,
                                     ref: Reference) -> float:
    """getLogProbOfReadGivenHaplotype (genomeFragment.c:71-89)."""
    total = 0
    for i in range(ps.length):
        j = i + ps.ref_start - start
        if 0 <= j < length:
            allele = int(hap_string[j])
            site = ref.sites[i + ps.ref_start]
            total -= int(ps.probs[site.allele_offset - ps.allele_offset + allele])
    return total / PROFILE_PROB_SCALAR


def log_prob_of_being_in_partition(ps: ProfileSeq, hap1: np.ndarray,
                                   hap2: np.ndarray, start: int, length: int,
                                   ref: Reference) -> float:
    """getLogProbabilityOfBeingInPartition (genomeFragment.c:91-99)."""
    i = log_prob_of_read_given_haplotype(hap1, start, length, ps, ref)
    j = log_prob_of_read_given_haplotype(hap2, start, length, ps, ref)
    return i - np.logaddexp(i, j)


def refine_genome_fragment(gf: GenomeFragment, hmm: RPHmm, path: List[int],
                           max_iterations: int):
    """stGenomeFragment_refineGenomeFragment (genomeFragment.c:165-232):
    greedily flip reads between partitions until stable."""
    p = list(path)
    iteration = 0
    while iteration < max_iterations:
        iteration += 1
        flip_1to2 = set()
        flip_2to1 = set()
        for key in gf.reads1:
            ps = gf.pseq_by_id[key]
            i = log_prob_of_read_given_haplotype(gf.haplotype_string1, gf.ref_start,
                                                 gf.length, ps, gf.reference)
            j = log_prob_of_read_given_haplotype(gf.haplotype_string2, gf.ref_start,
                                                 gf.length, ps, gf.reference)
            if i < j:
                flip_1to2.add(key)
        for key in gf.reads2:
            ps = gf.pseq_by_id[key]
            i = log_prob_of_read_given_haplotype(gf.haplotype_string2, gf.ref_start,
                                                 gf.length, ps, gf.reference)
            j = log_prob_of_read_given_haplotype(gf.haplotype_string1, gf.ref_start,
                                                 gf.length, ps, gf.reference)
            if i < j:
                flip_2to1.add(key)
        if not flip_1to2 and not flip_2to1:
            break
        gf.reads1 -= flip_1to2
        gf.reads2 -= flip_2to1
        gf.reads1 |= flip_2to1
        gf.reads2 |= flip_1to2
        flipping = flip_1to2 | flip_2to1
        for ci, col in enumerate(hmm.columns):
            part = p[ci]
            for i, ps in enumerate(col.seqs):
                if id(ps) in flipping:
                    part ^= (1 << i)
            p[ci] = part
            fill_in_predicted_genome(gf, part, col, hmm.ref)
