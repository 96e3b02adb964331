"""Chunk-level phasing orchestration: strand-split HMM merge, FB, traceback,
refinement, read assignment, filtered-read/variant handling.

Parity: bubbleGraph_phaseBubbleGraph (bubbleGraph.c:2673-2801),
stGenomeFragment_phaseBamChunkReads (genomeFragment.c:234-276),
bubbleGraph_partitionFilteredReadsFromVcfEntries (bubbleGraph.c:1749-1941),
bubbleGraph_phaseVcfEntriesFromHaplotaggedReads (bubbleGraph.c:2140-2351),
updateOriginalVcfEntriesWithBubbleData (vcf.c:511-592).
"""

from __future__ import annotations

import math
from typing import Dict, List, Set, Tuple

import numpy as np

from margin_tpu_torch.io.vcf import VcfEntry
from margin_tpu_torch.ops import pairhmm
from margin_tpu_torch.params import Params
from margin_tpu_torch.phase import rphmm
from margin_tpu_torch.phase.bubbles import (BubbleGraph, ProfileSeq, Reference,
                                      build_bubble_graph, get_profile_seqs,
                                      get_reference, score_sv_pairs,
                                      _qual_value)
from margin_tpu_torch.phase.fragment import (GenomeFragment, construct_genome_fragment,
                                       log_prob_of_being_in_partition,
                                       refine_genome_fragment)
from margin_tpu_torch.phase.readextract import ReadVcfSubstrings
from margin_tpu_torch.rle import RleString


def phase_bubble_graph(bg: BubbleGraph, ref: Reference,
                       reads: List[ReadVcfSubstrings], params: Params, device
                       ) -> Tuple[GenomeFragment, Dict[int, ProfileSeq]]:
    """bubbleGraph_phaseBubbleGraph (bubbleGraph.c:2673-2801). The
    read-partition HMMs' FBs run on `device` where
    `rphmm_device.use_device_fb` says so (the native engine comes first)."""
    pseqs = get_profile_seqs(bg, ref)
    profile_seqs = list(pseqs.values())

    if not profile_seqs:
        gf = GenomeFragment(ref, 0, 0)
        return gf, pseqs

    # depth filter (coordination.c:443-488 via bubbleGraph.c:2699)
    kept, discarded = rphmm.filter_reads_by_coverage_depth(
        profile_seqs, ref, params.phase)
    discarded_ids = {id(ps) for ps in discarded}

    # strand split in `reads` order (bubbleGraph.c:2702-2716)
    fwd, rev = [], []
    for r in reads:
        ps = pseqs.get(id(r))
        if ps is not None and id(ps) not in discarded_ids:
            (fwd if r.forward_strand else rev).append(ps)

    # native C++ merge-tree engine (native/marginrp.cc) mirrors the Python
    # oracle below operation-for-operation; safe because the depth filter
    # above already bounds coverage <= maxCoverageDepth <= 64
    from margin_tpu_torch.phase import native_rp
    hmm = native_rp.phase_fused_hmm(fwd, rev, ref, params.phase, device)
    if hmm is None:
        tp_f = rphmm.get_rp_hmms(fwd, ref, params.phase, device)
        tp_r = rphmm.get_rp_hmms(rev, ref, params.phase, device)

        merged = rphmm.merge_two_tiling_paths(tp_f, tp_r,
                                              include_ancestor=False)
        hmm = rphmm.fuse_tiling_path(merged)

        hmm.forward_backward(include_ancestor=True)
    path = hmm.forward_traceback()

    gf = construct_genome_fragment(hmm, path)
    refine_genome_fragment(gf, hmm, path, params.phase.roundsOfIterativeRefinement)

    # re-add depth-discarded reads to their best haplotype (bubbleGraph.c:2771-2779)
    from margin_tpu_torch.phase.fragment import log_prob_of_read_given_haplotype
    for ps in discarded:
        gf.pseq_by_id[id(ps)] = ps
        i = log_prob_of_read_given_haplotype(gf.haplotype_string1, gf.ref_start,
                                             gf.length, ps, gf.reference)
        j = log_prob_of_read_given_haplotype(gf.haplotype_string2, gf.ref_start,
                                             gf.length, ps, gf.reference)
        (gf.reads2 if i < j else gf.reads1).add(id(ps))

    return gf, pseqs


def phase_bam_chunk_reads(gf: GenomeFragment, pseqs: Dict[int, ProfileSeq],
                          reads: List[ReadVcfSubstrings], params: Params
                          ) -> Tuple[Set[int], Set[int], Dict[int, float]]:
    """stGenomeFragment_phaseBamChunkReads (genomeFragment.c:234-276).
    Returns (hap1 read id() set, hap2 read id() set, phred score per read)."""
    hap1: Set[int] = set()
    hap2: Set[int] = set()
    phreds: Dict[int, float] = {}
    for r in reads:
        ps = pseqs.get(id(r))
        if ps is None:
            continue
        in1 = id(ps) in gf.reads1
        if in1:
            lp = log_prob_of_being_in_partition(ps, gf.haplotype_string2,
                                                gf.haplotype_string1,
                                                gf.ref_start, gf.length, gf.reference)
        else:
            lp = log_prob_of_being_in_partition(ps, gf.haplotype_string1,
                                                gf.haplotype_string2,
                                                gf.ref_start, gf.length, gf.reference)
        phred = -10 * lp / 2.302585
        if phred < params.phase.minPhredScoreForHaplotypePartition:
            continue
        (hap1 if in1 else hap2).add(id(r))
        phreds[id(r)] = phred
    return hap1, hap2, phreds


def score_het_groups(groups, params: Params, tables: pairhmm.PairHmmTables,
                     use_lut=False, batch_max: int = 32768):
    """Batched scores of read substrings against two alleles for MANY
    (allele_a, allele_b, subs) groups at once — one padded kernel launch per
    size bucket instead of one per bubble. Returns a list of (n_subs, 2)
    float32 arrays; identical read substrings within a group share scores
    (the reference's per-bubble cache, bubbleGraph.c:1844-1875)."""
    use_rle = params.polish.useRunLengthEncoding
    outs = [np.zeros((len(subs), 2), dtype=np.float32)
            for _, _, subs in groups]
    dups = []
    pairs, strands, reps, owners = [], [], [], []
    for g, (allele_a, allele_b, subs) in enumerate(groups):
        a_sym = [allele_a.symbols(), allele_b.symbols()]
        a_rep = ([np.minimum(allele_a.counts, 50), np.minimum(allele_b.counts, 50)]
                 if use_rle else None)
        seen: Dict[str, int] = {}
        dup = np.arange(len(subs))
        for k, rs in enumerate(subs):
            key = rs.rle_string.expand()
            if key in seen:
                dup[k] = seen[key]
                continue
            seen[key] = k
            y = rs.rle_string.symbols()
            yr = np.minimum(rs.rle_string.counts, 50) if use_rle else None
            for j in range(2):
                pairs.append((a_sym[j], y))
                strands.append(0 if rs.read.forward_strand else 1)
                if use_rle:
                    reps.append((a_rep[j], yr))
                owners.append((g, k, j))
        dups.append(dup)
    # SV-length pairs take the kmer-anchored banded kernel
    scored, pairs, strands, reps, owners = score_sv_pairs(
        tables, pairs, strands, reps, owners, use_rle,
        params.phase.referenceExpansionForStructuralVariants,
        params.polish.p.diagonalExpansion, use_lut)
    for (g, k, j), total in scored:
        outs[g][k, j] = total
    if pairs:
        from margin_tpu_torch.parallel import executor
        scores = executor.score_pairs(tables, pairs, strands,
                                      rep_pairs=reps if use_rle else None,
                                      use_lut=use_lut, batch_max=batch_max)
        for (g, k, j), s in zip(owners, scores):
            outs[g][k, j] = s
    for out, dup in zip(outs, dups):
        for k in range(len(dup)):
            if dup[k] != k:
                out[k] = out[dup[k]]
    return outs


def _score_het_bubble(allele_a: RleString, allele_b: RleString,
                      subs: List, params: Params,
                      tables: pairhmm.PairHmmTables, use_lut=False):
    """Single-group convenience wrapper around score_het_groups."""
    return score_het_groups([(allele_a, allele_b, subs)], params, tables,
                            use_lut)[0]


def _entry_to_read_substrings(reads: List[ReadVcfSubstrings], params: Params):
    """buildVcfEntryToReadSubstringsMap (bubbleGraph.c:1281-1323): entry id ->
    [ReadSubstring] in read order."""
    from margin_tpu_torch.phase.bubbles import ReadSubstring
    use_rle = params.polish.useRunLengthEncoding
    m: Dict[int, List] = {}
    for r in reads:
        for entry, sub, quals in zip(r.vcf_entries, r.substrings, r.qualities):
            rs = ReadSubstring(
                r, RleString.encode(sub) if use_rle else RleString.identity(sub),
                _qual_value(quals))
            m.setdefault(id(entry), []).append(rs)
    return m


def partition_filtered_reads(filtered_reads: List[ReadVcfSubstrings],
                             gf: GenomeFragment, bg: BubbleGraph,
                             entries_to_bubbles: List[VcfEntry],
                             hap1_ids: Set[int], hap2_ids: Set[int],
                             params: Params, tables: pairhmm.PairHmmTables):
    """bubbleGraph_partitionFilteredReadsFromVcfEntries
    (bubbleGraph.c:1749-1941): score each filtered read against the two
    phased haplotype alleles at every het bubble, accumulate normalized
    supports, then assign to the better haplotype."""
    scores1 = {id(r): 0.0 for r in filtered_reads}
    scores2 = {id(r): 0.0 for r in filtered_reads}
    entry_subs = _entry_to_read_substrings(filtered_reads, params)

    groups = []
    for i in range(gf.length):
        b = bg.bubbles[gf.ref_start + i]
        entry = entries_to_bubbles[gf.ref_start + i]
        a1 = int(gf.haplotype_string1[i])
        a2 = int(gf.haplotype_string2[i])
        if a1 == a2:
            continue
        subs = entry_subs.get(id(entry))
        if not subs:
            continue
        # bubble alleles are the context-expanded allele substrings
        groups.append((b.alleles[a1], b.alleles[a2], list(reversed(subs))))
    for (_, _, subs), supports in zip(groups,
                                      score_het_groups(groups, params, tables)):
        for rs, (sa, sb) in zip(subs, supports.astype(np.float64)):
            tot = np.logaddexp(sa, sb)
            scores1[id(rs.read)] += sa - tot
            scores2[id(rs.read)] += sb - tot

    for r in filtered_reads:
        s1, s2 = scores1[id(r)], scores2[id(r)]
        if s1 > s2:
            hap1_ids.add(id(r))
        elif s2 > s1:
            hap2_ids.add(id(r))


def phase_filtered_vcf_entries(reads_for_filtered: List[ReadVcfSubstrings],
                               filtered_entries: List[VcfEntry],
                               hap1_names: Set[str], hap2_names: Set[str],
                               chunk, read_enumerator: Dict[str, int],
                               params: Params, tables: pairhmm.PairHmmTables):
    """bubbleGraph_phaseVcfEntriesFromHaplotaggedReads
    (bubbleGraph.c:2140-2351): phase low-quality variants using already
    haplotagged reads via cis/trans support voting."""
    entry_subs = _entry_to_read_substrings(reads_for_filtered, params)
    work = []
    groups = []
    for entry in filtered_entries:
        root = entry.root
        if entry.gt1 == entry.gt2:
            continue
        if root.ref_pos < chunk.chunk_start or root.ref_pos >= chunk.chunk_end:
            continue
        subs = entry_subs.get(id(entry))
        if not subs:
            continue
        tagged = [rs for rs in subs
                  if rs.read.read_name in hap1_names or rs.read.read_name in hap2_names]
        work.append((entry, subs, tagged))
        groups.append((entry.allele_substrings[entry.gt1],
                       entry.allele_substrings[entry.gt2], tagged))
    all_supports = score_het_groups(groups, params, tables)
    for (entry, subs, tagged), supports in zip(work, all_supports):
        root = entry.root
        cis = trans = 0.0
        if tagged:
            for rs, (sa, sb) in zip(tagged, supports.astype(np.float64)):
                tot = np.logaddexp(sa, sb)
                is_h1 = rs.read.read_name in hap1_names
                cis += (sa if is_h1 else sb) - tot
                trans += (sb if is_h1 else sa) - tot
        if cis > trans:
            gt1, gt2 = entry.gt1, entry.gt2
        elif trans > cis:
            gt1, gt2 = entry.gt2, entry.gt1
        else:
            gt1 = gt2 = -1
        root.phased_gt1 = gt1
        root.phased_gt2 = gt2
        root.genotype_prob = 0.0
        root.haplotype1_prob = 0.0
        root.haplotype2_prob = 0.0
        if gt1 == -1:
            continue
        root.was_updated = True
        h1set = root.allele_idx_to_read_ids[gt1]
        h2set = root.allele_idx_to_read_ids[gt2]
        for rs in subs:
            idx = read_enumerator.get(rs.read.read_name)
            if idx is None:
                continue
            if rs.read.read_name in hap1_names:
                h1set.add(idx)
            elif rs.read.read_name in hap2_names:
                h2set.add(idx)


def update_original_vcf_entries(chunk, reads: List[ReadVcfSubstrings],
                                read_enumerator: Dict[str, int],
                                gf: GenomeFragment, bg: BubbleGraph,
                                entries_to_bubbles: List[VcfEntry],
                                hap1_ids: Set[int], hap2_ids: Set[int]):
    """updateOriginalVcfEntriesWithBubbleData (vcf.c:511-592)."""
    # entry -> reads having a substring for it
    entry_reads: Dict[int, List[ReadVcfSubstrings]] = {}
    for r in reads:
        for e in r.vcf_entries:
            entry_reads.setdefault(id(e), []).append(r)

    for i in range(gf.length):
        entry = entries_to_bubbles[gf.ref_start + i]
        root = entry.root
        assert root is not None
        if root.ref_pos < chunk.chunk_start or root.ref_pos >= chunk.chunk_end:
            continue
        bcrs = entry_reads.get(id(entry), [])
        if not bcrs:
            root.phased_gt1 = -1
            root.phased_gt2 = -1
            root.genotype_prob = 0.0
            root.haplotype1_prob = 0.0
            root.haplotype2_prob = 0.0
            continue
        a1 = int(gf.haplotype_string1[i])
        a2 = int(gf.haplotype_string2[i])
        root.phased_gt1 = a1
        root.phased_gt2 = a2
        root.genotype_prob = math.pow(10.0, float(gf.genotype_probs[i]))
        root.haplotype1_prob = math.pow(10.0, float(gf.haplotype_probs1[i]))
        root.haplotype2_prob = math.pow(10.0, float(gf.haplotype_probs2[i]))
        root.was_updated = True
        h1set = root.allele_idx_to_read_ids[a1]
        h2set = root.allele_idx_to_read_ids[a2]
        for r in bcrs:
            idx = read_enumerator.get(r.read_name)
            if idx is None:
                continue
            if id(r) in hap1_ids:
                h1set.add(idx)
            elif id(r) in hap2_ids:
                h2set.add(idx)
