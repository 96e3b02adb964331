"""Diploid polish: bubble-graph phasing over the POA, per-haplotype POA
rebuild, phased repeat counts, filtered-read partitioning.

Copy of `margin_tpu/polish/diploid.py` with the port's imports; its allele
scoring goes through `phase/phasing.score_het_groups` and
`bubbles_poa.bubble_graph_from_poa` (the dense forward, K1), its
realignments through `poa.poa_realign` (K2 and K3). Parity: polish_main
diploid branch (polish.c:620-863),
getPaddedHaplotypeString (misc.c:100-111), bubbleGraph_getNewPoa
(bubbleGraph.c:2803-2823), bubbleGraph_partitionFilteredReads
(bubbleGraph.c:1500-...).
"""

from __future__ import annotations

from typing import List, Optional, Set

import numpy as np

from margin_tpu_torch.params import Params
from margin_tpu_torch.phase import phasing as phase_engine
from margin_tpu_torch.phase.bubbles import BubbleGraph
from margin_tpu_torch.phase.fragment import GenomeFragment
from margin_tpu_torch.polish import bubbles_poa, repeats
from margin_tpu_torch.polish.poa import Poa, PoaRead, poa_realign
from margin_tpu_torch.rle import RleString
from margin_tpu_torch.utils import profiling


def get_padded_haplotype_string(hap: np.ndarray, gf: GenomeFragment,
                                bg: BubbleGraph) -> np.ndarray:
    """getPaddedHaplotypeString (misc.c:100-111): consensus path with the
    genome fragment's haplotype alleles substituted over its span."""
    padded = bubbles_poa.get_consensus_path(bg)
    padded[gf.ref_start:gf.ref_start + gf.length] = hap
    return padded


def bubble_graph_get_new_poa(bg: BubbleGraph, consensus_path: np.ndarray,
                             poa: Poa, reads: List[PoaRead], params: Params,
                             tables, use_lut: bool = False) -> Poa:
    """bubbleGraph_getNewPoa (bubbleGraph.c:2803-2823)."""
    consensus, poa_to_consensus = bubbles_poa.get_consensus_string(
        bg, consensus_path, params.polish)
    anchor_alignments = poa.get_anchor_alignments(poa_to_consensus, len(reads),
                                                  params.polish)
    return poa_realign(reads, anchor_alignments, consensus, params.polish,
                       tables, use_lut=use_lut)


def produce_vcf_entries_from_bubble_graph(ref_name: str, bg: BubbleGraph,
                                          gf: GenomeFragment, pseqs,
                                          strand_skew_threshold: float,
                                          read_skew_threshold: float,
                                          log=None):
    """produceVcfEntriesFromBubbleGraph (misc.c:259-351): turn the phased
    het bubbles into VCF entries, dropping bubbles whose strand balance or
    read split fails a binomial test."""
    from margin_tpu_torch.io.vcf import VcfEntry
    from margin_tpu_torch.io.vcf_writer import binomial_pvalue

    entries = []
    passes = total = fails_strand = fails_read = 0
    for i in range(gf.length):
        b = bg.bubbles[gf.ref_start + i]
        a1 = int(gf.haplotype_string1[i])
        a2 = int(gf.haplotype_string2[i])
        if a1 == a2:  # we only care about hets
            continue
        hap1, hap2 = b.alleles[a1], b.alleles[a2]

        # read split between the two het alleles
        total_reads = hap1_reads = 0
        for j in range(len(b.reads)):
            s1 = float(b.allele_read_supports[a1, j])
            s2 = float(b.allele_read_supports[a2, j])
            if s1 != s2:
                total_reads += 1
                if s1 > s2:
                    hap1_reads += 1

        # strand skew over the HMM partitions (bubble_phasedStrandSkew,
        # bubbleGraph.c:2885-2903; uses gf reads1/reads2, pre-phred-filter)
        n = k = 0
        for rs in b.reads:
            ps = pseqs.get(id(rs.read))
            if ps is None:
                continue
            if id(ps) in gf.reads1:
                n += 1
                k += 1 if rs.read.forward_strand else 0
            elif id(ps) in gf.reads2:
                n += 1
                k += 0 if rs.read.forward_strand else 1
        strand_skew = binomial_pvalue(n, k)
        read_skew = binomial_pvalue(total_reads, hap1_reads)

        ok = True
        if strand_skew < strand_skew_threshold:
            fails_strand += 1
            ok = False
        if read_skew < read_skew_threshold:
            fails_read += 1
            ok = False
        if ok:
            for vp in getattr(b, "variant_position_offsets", []):
                # the reference's pointer-identity ref-allele check
                # (misc.c:319-330) never fires because bubble alleles are
                # fresh copies, so entries are always [ref, hap1, hap2] 1|2
                alleles = [b.ref_allele.copy(), hap1.copy(), hap2.copy()]
                entries.append(VcfEntry(
                    ref_name, int(b.ref_start + vp), -1, -1.0,
                    hap1.non_rle_length != hap2.non_rle_length, False,
                    alleles, 1, 2))
            passes += 1
        total += 1
    if log is not None:
        log(f"  kept {passes} of {total} bubbles after quality filtering "
            f"({fails_strand} strand / {fails_read} read-split failures)")
    return entries


def phase_poa(poa: Poa, reads: List[PoaRead], chunk_vcf_entries,
              params: Params, tables, ref_name: str = "ref",
              use_lut: bool = False, log=None,
              only_vcf_alleles: bool = False,
              rle_reference: Optional[RleString] = None):
    """The diploid bubble-finding + phasing loop (polish.c:644-714): build
    the bubble graph, phase, then (in no-VCF mode) refine by regenerating
    the graph from the skew-filtered het bubbles, up to
    bubbleFindingIterations extra rounds. Returns
    (bg, ref, gf, pseqs, hap1_ids, hap2_ids, phreds) where the id sets are
    id(PoaRead)."""
    vcf_entries = chunk_vcf_entries
    iteration = 0
    bg = ref = gf = pseqs = hap1_ids = hap2_ids = phreds = None
    while True:
        if iteration != 0:
            filtered = produce_vcf_entries_from_bubble_graph(
                ref_name, bg, gf, pseqs,
                params.phase.bubbleMinBinomialStrandLikelihood,
                params.phase.bubbleMinBinomialReadSplitLikelihood, log)
            # terminate or iterate (polish.c:655-661)
            if len(filtered) == 0 or len(filtered) == len(bg.bubbles):
                break
            vcf_entries = filtered
        if only_vcf_alleles:
            # polish.c:673-674
            bg = bubbles_poa.bubble_graph_from_poa_and_vcf_only_alleles(
                poa, reads, rle_reference, vcf_entries, params, tables,
                use_lut=use_lut)
        else:
            bg = bubbles_poa.bubble_graph_from_poa(poa, reads, vcf_entries,
                                                   params, tables,
                                                   phasing=True,
                                                   use_lut=use_lut)
        ref = phase_engine.get_reference(bg, ref_name, params)
        gf, pseqs = phase_engine.phase_bubble_graph(bg, ref, reads, params,
                                                    tables.device)
        hap1_ids, hap2_ids, phreds = phase_engine.phase_bam_chunk_reads(
            gf, pseqs, reads, params)
        iteration += 1
        if (chunk_vcf_entries is not None
                or iteration > params.phase.bubbleFindingIterations):
            break
    return bg, ref, gf, pseqs, hap1_ids, hap2_ids, phreds


def partition_filtered_reads_poa(filtered_poa: Poa,
                                 filtered_reads: List[PoaRead],
                                 gf: GenomeFragment, bg: BubbleGraph,
                                 hap1_ids: Set[int], hap2_ids: Set[int],
                                 params: Params, tables,
                                 use_lut: bool = False):
    """bubbleGraph_partitionFilteredReads (bubbleGraph.c:1500-...): score
    filtered reads against the phased haplotype alleles at het bubbles."""
    scores1 = {id(r): 0.0 for r in filtered_reads}
    scores2 = {id(r): 0.0 for r in filtered_reads}
    pp = params.polish
    groups = []
    for i in range(gf.length):
        b = bg.bubbles[gf.ref_start + i]
        a1 = int(gf.haplotype_string1[i])
        a2 = int(gf.haplotype_string2[i])
        if a1 == a2:
            continue
        subs = bubbles_poa.get_read_substrings(
            filtered_reads, filtered_poa, b.ref_start,
            b.ref_start + b.bubble_length + 1, pp, should_filter=False)
        if not subs:
            continue
        groups.append((b.alleles[a1], b.alleles[a2], subs))
    for (_, _, subs), supports in zip(
            groups, phase_engine.score_het_groups(groups, params, tables, use_lut)):
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


def diploid_chunk(poa: Poa, reads: List[PoaRead],
                  filtered_reads: List[PoaRead],
                  filtered_alignments, rle_reference: RleString,
                  chunk_vcf_entries, params: Params, tables,
                  ref_name: str = "ref", use_lut: bool = False,
                  collect: dict = None, only_vcf_alleles: bool = False,
                  output_fasta: bool = True, alignments=None, chunk=None,
                  rng=None, skip_filtered: bool = False,
                  skip_realignment: bool = False, profiler=profiling.NULL):
    """One chunk of the diploid polish path. Returns
    (hap1_consensus, hap2_consensus, hap1_names, hap2_names, gf).
    If `collect` is a dict, internal state needed for supplementary
    outputs (hap POAs, hap id sets, bubble graph) is stashed in it.
    With output_fasta=False (polish.c:719 skipOutputFasta) the per-hap
    POA construction is skipped and the consensus strings are empty.
    `profiler` times the stages under the chunk's index."""
    pp = params.polish
    ci = chunk.chunk_idx if chunk is not None else 0
    with profiler.chunk_stage(ci, "phasing"):
        bg, ref, gf, pseqs, hap1_ids, hap2_ids, phreds = phase_poa(
            poa, reads, chunk_vcf_entries, params, tables, ref_name, use_lut,
            only_vcf_alleles=only_vcf_alleles, rle_reference=rle_reference)

    poa_hap1 = poa_hap2 = None
    if output_fasta:
        hap1_path = get_padded_haplotype_string(
            gf.haplotype_string1[:gf.length], gf, bg)
        hap2_path = get_padded_haplotype_string(
            gf.haplotype_string2[:gf.length], gf, bg)

        with profiler.chunk_stage(ci, "hap_poa"):
            poa_hap1 = bubble_graph_get_new_poa(bg, hap1_path, poa, reads,
                                                params, tables, use_lut)
            poa_hap2 = bubble_graph_get_new_poa(bg, hap2_path, poa, reads,
                                                params, tables, use_lut)

        if pp.useRunLengthEncoding and pp.repeat_sub_matrix is not None:
            with profiler.chunk_stage(ci, "repeat_counts"):
                repeats.estimate_phased_repeat_counts(
                    poa_hap1, reads, pp.repeat_sub_matrix, hap1_ids, pp)
                repeats.estimate_phased_repeat_counts(
                    poa_hap2, reads, pp.repeat_sub_matrix, hap2_ids, pp)

    # unassigned primary reads join the filtered pool, keeping their
    # alignments as realignment anchors (polish.c:762-770); with
    # --skipFilteredReads only truth reads (already in filtered_reads via
    # the driver) remain to be partitioned (polish.c:760)
    all_filtered = list(filtered_reads)
    all_alns = (list(filtered_alignments)
                if filtered_alignments is not None
                else [None] * len(all_filtered))
    if not skip_filtered:
        for i, r in enumerate(reads):
            if id(r) not in hap1_ids and id(r) not in hap2_ids:
                all_filtered.append(r)
                all_alns.append(alignments[i] if alignments is not None
                                else None)

    if chunk is not None and all_filtered:
        # removeReadsOnlyInChunkBoundary (misc.c:171-194)
        cs = chunk.chunk_start - chunk.chunk_overlap_start
        ce = chunk.chunk_end - chunk.chunk_overlap_start
        kept_r, kept_a = [], []
        for r, a in zip(all_filtered, all_alns):
            if a is not None and len(a) > 0 and \
                    (int(a[-1][0]) < cs or int(a[0][0]) >= ce):
                continue
            kept_r.append(r)
            kept_a.append(a)
        all_filtered, all_alns = kept_r, kept_a

        # cap filtered reads at excessiveDepthThreshold
        # (downsampleViaFullReadLengthLikelihood, polish.c:780-800)
        if pp.excessiveDepthThreshold > 0 and rng is not None and all_filtered:
            from margin_tpu_torch.phase.downsample import knapsack_probs
            lengths = np.array([r.rle_read.length for r in all_filtered])
            span = chunk.chunk_overlap_end - chunk.chunk_overlap_start
            if lengths.sum() / span >= pp.excessiveDepthThreshold:
                metrics = np.array([r.full_read_length
                                    for r in all_filtered])
                probs = knapsack_probs(lengths, metrics,
                                       pp.excessiveDepthThreshold, span)
                kept_r, kept_a = [], []
                for r, a, p in zip(all_filtered, all_alns, probs):
                    if rng.random() < p:
                        kept_r.append(r)
                        kept_a.append(a)
                all_filtered, all_alns = kept_r, kept_a

    if all_filtered:
        with profiler.chunk_stage(ci, "filtered_reads"):
            if skip_realignment:
                # polish.c:815-817
                from margin_tpu_torch.polish.poa import \
                    poa_realign_only_anchor_alignments
                filtered_poa = poa_realign_only_anchor_alignments(
                    all_filtered, all_alns, rle_reference, pp)
            else:
                filtered_poa = poa_realign(all_filtered, all_alns,
                                           rle_reference, pp, tables,
                                           use_lut=use_lut)
            partition_filtered_reads_poa(filtered_poa, all_filtered, gf, bg,
                                         hap1_ids, hap2_ids, params, tables,
                                         use_lut)

    hap1_names = {r.read_name for r in reads + all_filtered if id(r) in hap1_ids}
    hap2_names = {r.read_name for r in reads + all_filtered if id(r) in hap2_ids}
    if collect is not None:
        collect.update(poa_hap1=poa_hap1, poa_hap2=poa_hap2, bg=bg, gf=gf,
                       hap1_ids=hap1_ids, hap2_ids=hap2_ids,
                       all_filtered=all_filtered)
    return (poa_hap1.ref_string.expand() if poa_hap1 is not None else "",
            poa_hap2.ref_string.expand() if poa_hap2 is not None else "",
            hap1_names, hap2_names, gf, phreds,
            {id(r): r.read_name for r in reads})
