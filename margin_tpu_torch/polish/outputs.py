"""Supplementary polish outputs: POA CSV/DOT, repeat-count CSV, phased POA
CSV, haplotype read-partition CSVs, and the phasing-state JSON.

Copy of `margin_tpu/polish/outputs.py` with the port's imports. Parity: poa_printRepeatCountsCSV (poa.c:879-900), poa_printDOT
(poa.c:902-980), printMLRepeatCounts (poa.c:982-1021), poa_printCSV
(poa.c:1027-1101), poa_printPhasedCSV (poa.c:1137-1259),
poaNode_getStrandSpecificBaseWeights (poa.c), writePhasedReadInfoJSON
(misc.c:196-256), stGenomeFragment_printPartitionAsCSV
(genomeFragment.c:101-122), poa_writeSupplementalChunkInformation[2]
(htsIntegration.c:1506-1587).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Set

import numpy as np

from margin_tpu_torch.alphabet import seq_to_symbols
from margin_tpu_torch.params import Params, RepeatSubMatrix
from margin_tpu_torch.polish.poa import PAIR1, Poa, PoaRead
from margin_tpu_torch.polish.repeats import _log_probs_for_counts

_SYMBOL_CHARS = "ACGTN"
POS_STRAND_IDX = 1  # margin.h:126
NEG_STRAND_IDX = 0


def _nfloat(numerator: float, denominator: float) -> float:
    """nFloat (poa.c:1023-1025)."""
    return 0.0 if denominator == 0.0 else numerator / denominator


def strand_specific_base_weights(node, reads: List[PoaRead],
                                 include_ids: Optional[Set[int]] = None):
    """poaNode_getStrandSpecificBaseWeights (poa.c): per-(symbol, strand)
    observation weights, optionally restricted to a read-id set. Returns
    (weights (10,), total, total_pos, total_neg)."""
    weights = np.zeros(10)
    total = total_pos = total_neg = 0.0
    for read_no, offset, w in node.observations:
        r = reads[read_no]
        if include_ids is not None and id(r) not in include_ids:
            continue
        total += w
        sym = int(seq_to_symbols(r.rle_read.bases[offset])[0])
        weights[sym * 2 + (POS_STRAND_IDX if r.forward_strand
                           else NEG_STRAND_IDX)] += w
        if r.forward_strand:
            total_pos += w
        else:
            total_neg += w
    return weights, total, total_pos, total_neg


def _ml_repeat_count_fields(rm: RepeatSubMatrix, base_sym: int,
                            observations, reads: List[PoaRead]) -> str:
    """printMLRepeatCounts (poa.c:982-1021): normalized repeat-count
    probability columns 1..maximumRepeatLength-1."""
    max_rl = rm.max_repeat
    lo, hi = max_rl, 0
    counts, ws, strands = [], [], []
    for read_no, offset, w in observations:
        r = reads[read_no]
        c = int(r.rle_read.counts[offset])
        lo = min(lo, c)
        hi = max(hi, c)
        counts.append(min(c, max_rl - 1))
        ws.append(w)
        strands.append(r.forward_strand)
    if hi >= max_rl:
        hi = max_rl - 1
    if lo == max_rl:  # no valid observations
        return "".join(",0" for _ in range(1, max_rl))
    lp = _log_probs_for_counts(rm, base_sym if base_sym < 4 else 0,
                               np.array(counts), np.array(ws),
                               np.array(strands), lo, hi)
    ln10 = 2.302585093
    total = np.logaddexp.reduce(lp * ln10)
    fields = []
    for _ in range(1, lo):
        fields.append(",0")
    for i in range(lo, hi + 1):
        fields.append(f",{math.exp(lp[i - lo] * ln10 - total):.6f}")
    for _ in range(hi + 1, max_rl):
        fields.append(",0")
    return "".join(fields)


def poa_print_repeat_counts_csv(poa: Poa, fh, reads: List[PoaRead]) -> None:
    """poa_printRepeatCountsCSV (poa.c:879-900)."""
    fh.write("REF_INDEX,REF_BASE")
    fh.write(",REPEAT_COUNT_OBSxN(READ_BASE,READ_STRAND,REPEAT_COUNT,WEIGHT)\n")
    for i, node in enumerate(poa.nodes):
        fh.write(f"{i},{node.base}")
        for read_no, offset, w in node.observations:
            r = reads[read_no]
            fh.write(f",{r.rle_read.bases[offset]}"
                     f"{'+' if r.forward_strand else '-'}"
                     f"{int(r.rle_read.counts[offset])},{w / PAIR1:.3f}")
        fh.write("\n")


def poa_print_dot(poa: Poa, fh, reads: List[PoaRead]) -> None:
    """poa_printDOT (poa.c:902-980)."""
    insert_c, backbone_c, delete_c = '"darkgreen"', '"blue"', '"purple"'
    fh.write('digraph poa {\nrankdir="LR";\n')
    for i, node in enumerate(poa.nodes):
        run_lengths = np.zeros(50)
        weight = 0.0
        for read_no, offset, w in node.observations:
            weight += w
            r = reads[read_no]
            if r.rle_read.bases[offset] != node.base:
                continue
            rl = min(int(r.rle_read.counts[offset]), 50)
            run_lengths[rl - 1] += w
        weight /= PAIR1
        labels = [str(i)]
        for rl in range(50):
            if run_lengths[rl] != 0:
                labels.append(f"{rl + 1:2d}{node.base} "
                              f"{int(run_lengths[rl] / PAIR1):2d}")
        label = "\\n".join(labels)
        pw = math.log(1 + weight)
        fh.write(f'B{i} [label="{label}", fontcolor={backbone_c}, '
                 f'color={backbone_c}, penwidth={pw:.6f}];\n')
        if i != 0:
            fh.write(f'B{i - 1} -> B{i} [label="{weight:.2f}", '
                     f'fontcolor={backbone_c}, color={backbone_c}, '
                     f'weight={math.ceil(weight)}, penwidth={pw:.6f}];\n')
        for j, insert in enumerate(node.inserts):
            iw = insert.weight / PAIR1
            ipw = math.log(1 + iw)
            fh.write(f'I{i}_{j} [label="{insert.insert.bases}", '
                     f'fontcolor={insert_c}, color={insert_c}, '
                     f'penwidth={ipw:.6f}];\n')
            fh.write(f'B{i} -> I{i}_{j} [label="{iw:.2f}", '
                     f'fontcolor={insert_c}, color={insert_c}, '
                     f'weight={math.ceil(iw)}, penwidth={ipw:.6f}];\n')
            fh.write(f'I{i}_{j} -> B{i + 1} [color={insert_c}, '
                     f'weight={math.ceil(iw)}, penwidth={ipw:.6f}];\n')
        for delete in node.deletes:
            dw = delete.weight / PAIR1
            dpw = math.log(1 + dw)
            fh.write(f'B{i} -> B{i + 1 + delete.length} [label="{dw:.2f}", '
                     f'fontcolor={delete_c}, color={delete_c}, '
                     f'weight={math.ceil(dw)}, penwidth={dpw:.6f}];\n')
    fh.write("}\n")


def poa_print_csv(poa: Poa, fh, reads: List[PoaRead], rm: RepeatSubMatrix,
                  indel_significance_threshold: float = 5.0) -> None:
    """poa_printCSV (poa.c:1027-1101)."""
    fh.write("REF_INDEX,REF_BASE,REPEAT_COUNT,TOTAL_WEIGHT,FRACTION_POS_STRAND")
    for c in _SYMBOL_CHARS:
        fh.write(f",FRACTION_BASE_{c}_WEIGHT,FRACTION_BASE_{c}_POS_STRAND")
    for j in range(1, rm.max_repeat):
        fh.write(f",PROB_REPEAT_COUNT_{j}")
    fh.write(",INSERTS")
    fh.write(",DELETES\n")

    for i, node in enumerate(poa.nodes):
        bw, total, total_pos, total_neg = strand_specific_base_weights(node, reads)
        fh.write(f"{i},{node.base},{node.repeat_count},"
                 f"{_nfloat(total, PAIR1):.6f},"
                 f"{_nfloat(total_pos, total_pos + total_neg):.6f}")
        for j in range(5):
            pos_w, neg_w = bw[j * 2 + 1], bw[j * 2 + 0]
            fh.write(f",{_nfloat(node.base_weights[j], total):.6f},"
                     f"{_nfloat(pos_w, pos_w + neg_w):.6f}")
        base_sym = int(seq_to_symbols(node.base)[0])
        fh.write(_ml_repeat_count_fields(rm, base_sym, node.observations, reads))
        fh.write(",")
        for insert in node.inserts:
            if insert.weight / PAIR1 >= indel_significance_threshold:
                fh.write(f"|{insert.insert.expand()}"
                         f"|{_nfloat(insert.weight, PAIR1):.6f}"
                         f"|{_nfloat(insert.weight_fwd, insert.weight):.6f}")
        fh.write(",")
        for delete in node.deletes:
            if delete.weight / PAIR1 >= indel_significance_threshold:
                fh.write(f"|{delete.length}"
                         f"|{_nfloat(delete.weight, PAIR1):.6f}"
                         f"|{_nfloat(delete.weight_fwd, delete.weight):.6f}")
        fh.write("\n")


def _phased_indel_fields(observations, reads: List[PoaRead],
                         hap1_ids: Set[int], hap2_ids: Set[int]) -> str:
    """poa_printPhasedCSV_indelPrint (poa.c:1103-1135)."""
    p1 = n1 = p2 = n2 = 0.0
    for read_no, _offset, w in observations:
        r = reads[read_no]
        if id(r) in hap1_ids:
            if r.forward_strand:
                p1 += w
            else:
                n1 += w
        elif id(r) in hap2_ids:
            if r.forward_strand:
                p2 += w
            else:
                n2 += w
    total = p1 + n1 + p2 + n2
    return (f"|{_nfloat(total, PAIR1):.6f}|{_nfloat(p1 + n1, total):.6f}"
            f"|{_nfloat(p2 + n2, total):.6f}|{_nfloat(p1, p1 + n1):.6f}"
            f"|{_nfloat(p2, p2 + n2):.6f}")


def poa_print_phased_csv(poa: Poa, fh, reads: List[PoaRead],
                         hap1_ids: Set[int], hap2_ids: Set[int],
                         rm: RepeatSubMatrix,
                         indel_significance_threshold: float = 5.0) -> None:
    """poa_printPhasedCSV (poa.c:1137-1259)."""
    fh.write("REF_INDEX,REF_BASE,REPEAT_COUNT,TOTAL_WEIGHT,"
             "FRACTION_HAP1_WEIGHT,FRACTION_HAP2_WEIGHT,"
             "FRACTION_POS_STRAND_HAP1,FRACTION_POS_STRAND_HAP2")
    for c in _SYMBOL_CHARS:
        fh.write(f",FRACTION_BASE_{c}_WEIGHT,FRACTION_BASE_{c}_HAP1,"
                 f"FRACTION_BASE_{c}_HAP2,FRACTION_BASE_{c}_POS_STRAND_HAP1,"
                 f"FRACTION_BASE_{c}_POS_STRAND_HAP2")
    for j in range(1, rm.max_repeat):
        fh.write(f",PROB_HAP1_REPEAT_COUNT_{j}")
    for j in range(1, rm.max_repeat):
        fh.write(f",PROB_HAP2_REPEAT_COUNT_{j}")
    fh.write(",INSERTS,DELETES\n")

    for i, node in enumerate(poa.nodes):
        bw, total, _tp, _tn = strand_specific_base_weights(node, reads)
        bw1, total1, pos1, _n1 = strand_specific_base_weights(node, reads, hap1_ids)
        bw2, total2, pos2, _n2 = strand_specific_base_weights(node, reads, hap2_ids)
        fh.write(f"{i},{node.base},{node.repeat_count},"
                 f"{_nfloat(total, PAIR1):.6f},"
                 f"{_nfloat(total1, total):.6f},{_nfloat(total2, total):.6f},"
                 f"{_nfloat(pos1, total1):.6f},{_nfloat(pos2, total2):.6f}")
        for j in range(5):
            tb = bw[j * 2 + 1] + bw[j * 2 + 0]
            t1 = bw1[j * 2 + 1] + bw1[j * 2 + 0]
            t2 = bw2[j * 2 + 1] + bw2[j * 2 + 0]
            fh.write(f",{_nfloat(tb, total):.6f},{_nfloat(t1, tb):.6f},"
                     f"{_nfloat(t2, tb):.6f},{_nfloat(bw1[j * 2 + 1], t1):.6f},"
                     f"{_nfloat(bw2[j * 2 + 1], t2):.6f}")
        # hap-split observations: reads not in hap1 count as hap2
        # (poa.c:1209-1216)
        obs1 = [o for o in node.observations if id(reads[o[0]]) in hap1_ids]
        obs2 = [o for o in node.observations if id(reads[o[0]]) not in hap1_ids]
        base_sym = int(seq_to_symbols(node.base)[0])
        fh.write(_ml_repeat_count_fields(rm, base_sym, obs1, reads))
        fh.write(_ml_repeat_count_fields(rm, base_sym, obs2, reads))
        fh.write(",")
        for insert in node.inserts:
            if insert.weight / PAIR1 >= indel_significance_threshold:
                fh.write(f"|{insert.insert.expand()}")
                fh.write(_phased_indel_fields(insert.observations, reads,
                                              hap1_ids, hap2_ids))
        fh.write(",")
        for delete in node.deletes:
            if delete.weight / PAIR1 >= indel_significance_threshold:
                fh.write(f"|{delete.length}")
                fh.write(_phased_indel_fields(delete.observations, reads,
                                              hap1_ids, hap2_ids))
        fh.write("\n")


def write_phased_read_info_json(chunk, reads: List[PoaRead], alignments,
                                f_reads: List[PoaRead], f_alignments,
                                hap1_ids: Set[int], hap2_ids: Set[int],
                                rle_to_non_rle_map: np.ndarray, fh) -> None:
    """writePhasedReadInfoJSON (misc.c:196-256)."""
    fh.write(',\n "reads": [')
    first = True
    for rlist, alist in ((reads, alignments), (f_reads, f_alignments)):
        for r, aln in zip(rlist, alist):
            if len(aln) == 0:
                continue  # the reference would crash here; skip instead
            hap = 1 if id(r) in hap1_ids else (2 if id(r) in hap2_ids else 0)
            start = chunk.chunk_overlap_start + int(rle_to_non_rle_map[aln[0][0]])
            end = chunk.chunk_overlap_start + int(rle_to_non_rle_map[aln[-1][0]])
            if not first:
                fh.write(",")
            first = False
            fh.write("\n  {\n")
            fh.write(f'     "name": "{r.read_name}",\n')
            fh.write(f'     "strand": "{"+" if r.forward_strand else "-"}",\n')
            fh.write(f'     "startPos": {start},\n')
            fh.write(f'     "endPos": {end},\n')
            fh.write(f'     "hap": {hap}\n')
            fh.write("  }")
    fh.write("\n ]")


def bubble_phased_strand_skew(bubble, hap1_ids: Set[int],
                              hap2_ids: Set[int]) -> float:
    """bubble_phasedStrandSkew (bubbleGraph.c:2885-2903): binomial p-value
    of the strand balance among phased reads (hap2 reads count reverse
    strand as positive)."""
    from margin_tpu_torch.io.vcf_writer import binomial_pvalue
    n = k = 0
    for rs in bubble.reads:
        if id(rs.read) in hap1_ids:
            n += 1
            if rs.read.forward_strand:
                k += 1
        elif id(rs.read) in hap2_ids:
            n += 1
            if not rs.read.forward_strand:
                k += 1
    return binomial_pvalue(n, k)


def save_bubble_phasing_info(chunk, bg, gf, hap1_ids: Set[int],
                             hap2_ids: Set[int],
                             rle_to_non_rle_map: np.ndarray, fh) -> None:
    """bubbleGraph_saveBubblePhasingInfo (bubbleGraph.c:2604-2658): per-het
    bubble JSON with strand skew and per-read haplotype supports."""
    fh.write(' "primary": [')
    first_bubble = True
    for i in range(gf.length):
        b = bg.bubbles[gf.ref_start + i]
        h1 = int(gf.haplotype_string1[i])
        h2 = int(gf.haplotype_string2[i])
        if b.alleles[h1] == b.alleles[h2]:
            continue
        fh.write("\n  {\n" if first_bubble else ",\n  {\n")
        first_bubble = False
        true_ref_pos = chunk.chunk_overlap_start + \
            int(rle_to_non_rle_map[b.ref_start])
        skew = bubble_phased_strand_skew(b, hap1_ids, hap2_ids)
        fh.write(f'   "refPos": {true_ref_pos},\n')
        fh.write(f'   "rleRefPos": {b.ref_start},\n')
        fh.write(f'   "strandSkew": {skew:.6f},\n')
        fh.write('   "reads": [')
        for j, rs in enumerate(b.reads):
            if j != 0:
                fh.write(",")
            fh.write("\n    {\n")
            fh.write(f'     "name": "{rs.read.read_name}",\n')
            fh.write(f'     "qual": {rs.qual_value:.6f},\n')
            fh.write(f'     "hapSupportH1": {b.allele_read_supports[h1, j]:.6f},\n')
            fh.write(f'     "hapSupportH2": {b.allele_read_supports[h2, j]:.6f}\n')
            fh.write("    }")
        fh.write("\n   ]")
        fh.write("\n  }")
    fh.write("\n ]")


def write_partition_csv(fh, hap_reads: Dict[str, float],
                        min_phred: float) -> None:
    """stGenomeFragment_printPartitionAsCSV (genomeFragment.c:101-122):
    read names with the phred probability of correct partition placement,
    gated at minPhredScoreForHaplotypePartition."""
    fh.write("READ_NAME,PHRED_SCORE_OF_BEING_IN_PARTITION\n")
    for name, p in hap_reads.items():
        if p > min_phred:
            fh.write(f"{name},{p:.6f}\n")


def _chunk_file_base(output_base: str, prefix: str, chunk_idx: int, chunk,
                     hap_identifier: str = "") -> str:
    return (f"{output_base}.{prefix}.C{chunk_idx:05d}.{chunk.ref_name}-"
            f"{chunk.chunk_overlap_start}-{chunk.chunk_overlap_end}"
            f"{hap_identifier}")


def write_supplemental_chunk_information(output_base: str, chunk_idx: int,
                                         chunk, poa: Poa,
                                         reads: List[PoaRead],
                                         params: Params,
                                         output_dot: bool = False,
                                         output_csv: bool = False,
                                         output_repeat_counts: bool = False,
                                         hap_identifier: str = "") -> List[str]:
    """poa_writeSupplementalChunkInformation2 (htsIntegration.c:1506-1537).
    Returns the list of files written."""
    written = []
    if output_dot:
        path = _chunk_file_base(output_base, "poa", chunk_idx, chunk,
                                hap_identifier) + ".dot"
        with open(path, "w") as fh:
            poa_print_dot(poa, fh, reads)
        written.append(path)
    if output_csv:
        path = _chunk_file_base(output_base, "poa", chunk_idx, chunk,
                                hap_identifier) + ".csv"
        with open(path, "w") as fh:
            poa_print_csv(poa, fh, reads, params.polish.repeat_sub_matrix, 5)
        written.append(path)
    if output_repeat_counts:
        path = _chunk_file_base(output_base, "repeatCount", chunk_idx, chunk,
                                hap_identifier) + ".csv"
        with open(path, "w") as fh:
            poa_print_repeat_counts_csv(poa, fh, reads)
        written.append(path)
    return written
