"""Local phasing correctness (LPC) metric + calcLocalPhasingCorrectness CLI.

Copy of `margin_tpu/tools/lpc.py` with the port's imports.

Parity: impl/localPhasingCorrectness.c and
tools/calcLocalPhasingCorrectness.c — decay-weighted pair correctness
between query and truth phased VCFs over a grid of length scales.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from margin_tpu_torch.io.vcf import _open_text


@dataclass
class PhasedVariant:
    ref_name: str
    ref_pos: int
    quality: float
    alleles: List[str]
    gt1: int
    gt2: int
    phase_set: str


def get_phased_variants(vcf_file: str) -> Dict[str, List[PhasedVariant]]:
    """getPhasedVariants (localPhasingCorrectness.c:37-179): PASS, het,
    phased (PS present) records only."""
    entries: Dict[str, List[PhasedVariant]] = {}
    for line in _open_text(vcf_file):
        if not line or line.startswith("#"):
            continue
        parts = line.split("\t")
        if len(parts) < 10:
            continue
        if parts[6] not in ("PASS", "."):
            continue
        fmt = parts[8].split(":")
        sample = parts[9].split(":")
        if "GT" not in fmt:
            continue
        gt = sample[fmt.index("GT")]
        sep = "|" if "|" in gt else "/"
        fields = gt.split(sep)
        if len(fields) < 2 or fields[0] in (".", ""):
            continue
        try:
            gt1, gt2 = int(fields[0]), int(fields[1])
        except ValueError:
            continue
        if gt1 == gt2:
            continue
        if "PS" not in fmt or fmt.index("PS") >= len(sample):
            continue
        ps = sample[fmt.index("PS")]
        if ps in (".", "", "0"):
            continue
        alleles = [parts[3]] + parts[4].split(",")
        pv = PhasedVariant(parts[0], int(parts[1]) - 1,
                           0.0 if parts[5] == "." else float(parts[5]),
                           alleles, gt1, gt2, ps)
        entries.setdefault(parts[0], []).append(pv)
    for lst in entries.values():
        lst.sort(key=lambda v: v.ref_pos)
    return entries


def _allele_matches(q: PhasedVariant, t: PhasedVariant):
    m11 = q.alleles[q.gt1] == t.alleles[t.gt1]
    m12 = q.alleles[q.gt1] == t.alleles[t.gt2]
    m21 = q.alleles[q.gt2] == t.alleles[t.gt1]
    m22 = q.alleles[q.gt2] == t.alleles[t.gt2]
    if not (m11 or m12) or not (m21 or m22):
        return None  # alleles don't match, skip
    if m11 + m12 + m21 + m22 > 2:
        return None  # duplicate alleles
    return m11


def mean_variant_dist(query, truth, shared_contigs) -> float:
    """meanVariantDist (localPhasingCorrectness.c:230-289)."""
    dist_sum = 0
    n_pairs = 0
    for contig in shared_contigs:
        qs, ts = query[contig], truth[contig]
        prev = -1
        i = j = 0
        while i < len(qs) and j < len(ts):
            if qs[i].ref_pos < ts[j].ref_pos:
                i += 1
            elif ts[j].ref_pos < qs[i].ref_pos:
                j += 1
            else:
                q, t = qs[i], ts[j]
                i += 1
                j += 1
                if _allele_matches(q, t) is None:
                    continue
                if prev != -1:
                    dist_sum += q.ref_pos - prev
                    n_pairs += 1
                prev = q.ref_pos
    return dist_sum / n_pairs if n_pairs else float("nan")


def _phase_set_intervals(variants: List[PhasedVariant]) -> Dict[str, List[int]]:
    intervals: Dict[str, List[int]] = {}
    for i, pv in enumerate(variants):
        iv = intervals.get(pv.phase_set)
        if iv is None:
            intervals[pv.phase_set] = [i, i]
        else:
            iv[1] = i
    return intervals


def _phasing_correctness_internal(qs, ts, decay, by_seq_dist, cross_block,
                                  q_intervals, t_intervals, forward,
                                  variant_correctness: Optional[list]):
    """phasingCorrectnessInternal (localPhasingCorrectness.c:328-541)."""
    partial_sums: List[list] = []  # [q_ps, t_ps, sum1, sum2]
    total = 0.0
    partition_total = 0.0
    out_of_scope = 0.0
    if forward:
        i, j, incr = 0, 0, 1
    else:
        i, j, incr = len(qs) - 1, len(ts) - 1, -1
    prev_pos = -1
    while 0 <= i < len(qs) and 0 <= j < len(ts):
        q, t = qs[i], ts[j]
        if (q.ref_pos < t.ref_pos and forward) or (q.ref_pos > t.ref_pos and not forward):
            i += incr
        elif (t.ref_pos < q.ref_pos and forward) or (t.ref_pos > q.ref_pos and not forward):
            j += incr
        else:
            m11 = _allele_matches(q, t)
            i += incr
            j += incr
            if m11 is None:
                continue
            if by_seq_dist:
                decay_value = decay ** abs(q.ref_pos - prev_pos)
            else:
                decay_value = decay
            for s in partial_sums:
                s[2] *= decay_value
                s[3] *= decay_value
            out_of_scope *= decay_value

            found = False
            for s in partial_sums:
                if s[0] == q.phase_set and s[1] == t.phase_set:
                    found = True
                    partition_total += s[2] + s[3]
                    if m11:
                        total += s[2]
                        s[2] += 1.0
                        if variant_correctness is not None:
                            variant_correctness.append([q.ref_pos, s[2], s[2] + s[3]])
                    else:
                        total += s[3]
                        s[3] += 1.0
                        if variant_correctness is not None:
                            variant_correctness.append([q.ref_pos, s[3], s[2] + s[3]])
                elif cross_block:
                    total += s[2] + s[3]
                    partition_total += s[2] + s[3]
                    if variant_correctness is not None:
                        variant_correctness.append([q.ref_pos, s[2] + s[3], s[2] + s[3]])
            total += out_of_scope
            partition_total += out_of_scope
            if not found:
                s = [q.phase_set, t.phase_set, 0.0, 0.0]
                if m11:
                    s[2] = 1.0
                else:
                    s[3] = 1.0
                partial_sums.append(s)
                if variant_correctness is not None:
                    variant_correctness.append([q.ref_pos, 0.0, 0.0])
            if variant_correctness is not None:
                variant_correctness[-1][1] += out_of_scope
                variant_correctness[-1][2] += out_of_scope
            prev_pos = q.ref_pos

        # drop phase-set pairs that fell out of scope
        k = 0
        while k < len(partial_sums):
            s = partial_sums[k]
            qi = q_intervals[s[0]]
            ti = t_intervals[s[1]]
            if i < qi[0] or i > qi[1] or j < ti[0] or j > ti[1]:
                if cross_block:
                    out_of_scope += s[2] + s[3]
                partial_sums[k] = partial_sums[-1]
                partial_sums.pop()
            else:
                k += 1
    return total, partition_total


def _switch_correctness(qs, ts, by_seq_dist, cross_block,
                        variant_correctness: Optional[list] = None):
    """switchCorrectness (localPhasingCorrectness.c:543-684): the decay->0
    limit (adjacent-pair switch correctness). If `variant_correctness` is a
    list, per-variant [ref_pos, correctness, max_correctness] triples are
    appended (tools -p/--per-variant)."""
    prev_q_ps = prev_t_ps = None
    prev_in_phase = False
    prev_pos = -1
    min_dist = float("inf")
    n_correct = 0
    n_possible = 0
    min_counted = 0
    prev_counted = prev_correct = False
    counted = correct = False
    i = j = 0
    while i < len(qs) and j < len(ts):
        q, t = qs[i], ts[j]
        if q.ref_pos < t.ref_pos:
            i += 1
        elif t.ref_pos < q.ref_pos:
            j += 1
        else:
            m11 = _allele_matches(q, t)
            i += 1
            j += 1
            if m11 is None:
                continue
            counted = correct = False
            if prev_q_ps is not None and prev_t_ps is not None:
                dist = q.ref_pos - prev_pos
                ps_match = (q.phase_set == prev_q_ps and t.phase_set == prev_t_ps)
                if dist < min_dist and by_seq_dist and (ps_match or cross_block):
                    n_possible = 0
                    n_correct = 0
                    prev_counted = False
                    min_dist = dist
                    if variant_correctness is not None:
                        min_counted = len(variant_correctness)
                if dist == min_dist or not by_seq_dist:
                    counted = ps_match or cross_block
                    correct = ((ps_match and m11 == prev_in_phase)
                               or (not ps_match and cross_block))
                    if counted:
                        n_possible += 1
                    if correct:
                        n_correct += 1
            if variant_correctness is not None:
                variant_correctness.append([q.ref_pos, 0.0, 0.0])
                if len(variant_correctness) > 1:
                    pvc = variant_correctness[-2]
                    pvc[1] = (int(prev_correct and prev_counted)
                              + int(correct and counted))
                    pvc[2] = int(prev_counted) + int(counted)
            prev_in_phase = m11
            prev_q_ps = q.phase_set
            prev_t_ps = t.phase_set
            prev_pos = q.ref_pos
            prev_correct = correct
            prev_counted = counted
    if variant_correctness:
        variant_correctness[-1][1] = float(correct and counted)
        variant_correctness[-1][2] = float(counted)
        # reset any variants counted before the min distance was found
        for k in range(min_counted):
            variant_correctness[k][1] = 0.0
            variant_correctness[k][2] = 0.0
    return (n_correct / n_possible if n_possible else float("nan")), n_possible


def phasing_correctness(query: List[PhasedVariant], truth: List[PhasedVariant],
                        decay: float, by_seq_dist: bool = False,
                        cross_block_correct: bool = False,
                        variant_correctness: Optional[list] = None
                        ) -> Tuple[float, float]:
    """phasingCorrectness (localPhasingCorrectness.c:686-751). Returns
    (correctness, effective_pair_count). If `variant_correctness` is a list,
    per-variant [ref_pos, correctness, max_correctness] triples are appended
    (forward + mirrored reverse contributions summed, c:725-734)."""
    if not 0.0 <= decay <= 1.0:
        raise ValueError("decay must be in [0, 1]")
    if decay == 0.0:
        return _switch_correctness(query, truth, by_seq_dist,
                                   cross_block_correct, variant_correctness)
    q_int = _phase_set_intervals(query)
    t_int = _phase_set_intervals(truth)
    rev_vc = None if variant_correctness is None else []
    f_tot, f_part = _phasing_correctness_internal(
        query, truth, decay, by_seq_dist, cross_block_correct, q_int, t_int,
        True, variant_correctness)
    r_tot, r_part = _phasing_correctness_internal(
        query, truth, decay, by_seq_dist, cross_block_correct, q_int, t_int,
        False, rev_vc)
    if variant_correctness is not None:
        for k, fvc in enumerate(variant_correctness):
            rvc = rev_vc[len(rev_vc) - k - 1]
            fvc[1] += rvc[1]
            fvc[2] += rvc[2]
    denom = f_part + r_part
    return ((f_tot + r_tot) / denom if denom else float("nan")), denom


def main(argv=None):
    """calcLocalPhasingCorrectness CLI (tools/calcLocalPhasingCorrectness.c)."""
    import argparse
    import sys
    p = argparse.ArgumentParser(prog="calcLocalPhasingCorrectness")
    p.add_argument("truth_vcf")
    p.add_argument("query_vcf")
    p.add_argument("-n", "--grid-num", type=int, default=200)
    p.add_argument("-m", "--grid-min", type=float, default=1e-2)
    p.add_argument("-M", "--grid-max", type=float, default=1e5)
    p.add_argument("-d", "--by-seq-dist", action="store_true")
    p.add_argument("-c", "--cross-block-correct", action="store_true")
    p.add_argument("-s", "--report-eff-size", action="store_true")
    p.add_argument("-p", "--per-variant", action="store_true",
                   help="report values for variants instead of contigs")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="do not log progress to stderr")
    args = p.parse_args(argv)
    progress = ((lambda *a: None) if args.quiet
                else (lambda msg: print(msg, file=sys.stderr)))

    n = args.grid_num
    if n < 4:
        p.error("Must have a grid of at least 4 values")
    if args.grid_min >= args.grid_max:
        p.error("Minimum grid value must be less than maximum grid value")
    if args.grid_min <= 0.0:
        p.error("Minimum grid value must be > 0")
    if args.per_variant and args.report_eff_size:
        p.error("Cannot report effective size for variants, only for contigs")
    step = (math.log(args.grid_max) - math.log(args.grid_min)) / (n - 3)
    length_scales = [0.0] + [math.exp(math.log(args.grid_min) + (i - 1) * step)
                             for i in range(1, n - 1)] + [float("inf")]
    decays = [0.0] + [math.exp(-math.log(2.0) / ls) for ls in length_scales[1:-1]] + [1.0]

    progress(f"Reading VCF {args.truth_vcf}...")
    truth = get_phased_variants(args.truth_vcf)
    progress(f"Reading VCF {args.query_vcf}...")
    query = get_phased_variants(args.query_vcf)
    shared = sorted(set(truth) & set(query))
    progress(f"Found {len(shared)} shared contigs (truth {len(truth)}, "
             f"query {len(query)})")
    var_dist = mean_variant_dist(truth, query, shared)

    header = ["decay"]
    header.append(("approx_" if args.by_seq_dist else "") + "length_scale_num_vars")
    header.append(("" if args.by_seq_dist else "approx_") + "length_scale_bps")

    if args.per_variant:
        # tools/calcLocalPhasingCorrectness.c:324-357: one column per shared
        # variant named <contig>_<refPos>, values correctness/maxCorrectness
        per_var_rows = []
        for k, (ls, decay) in enumerate(zip(length_scales, decays)):
            per_contig = []
            for contig in shared:
                vc = []
                phasing_correctness(truth[contig], query[contig], decay,
                                    args.by_seq_dist,
                                    args.cross_block_correct,
                                    variant_correctness=vc)
                per_contig.append(vc)
            per_var_rows.append(per_contig)
            if (k + 1) % max(1, n // 5) == 0:
                progress(f"Finished computing correctness for {k + 1} of "
                         f"{n} length scales")
        for contig, vc in zip(shared, per_var_rows[0]):
            header.extend(f"{contig}_{v[0]}" for v in vc)
        print("\t".join(header))
        for (ls, decay), per_contig in zip(zip(length_scales, decays),
                                           per_var_rows):
            row = [f"{decay:.17g}",
                   f"{(ls / var_dist if args.by_seq_dist else ls):.17g}",
                   f"{(ls if args.by_seq_dist else ls * var_dist):.17g}"]
            for vc in per_contig:
                row.extend(f"{(v[1] / v[2] if v[2] != 0.0 else float('nan')):.17g}"
                           for v in vc)
            print("\t".join(row))
        return 0

    for contig in shared:
        if args.report_eff_size:
            header.append(f"{contig}_eff_size")
        header.append(contig)
    if args.report_eff_size:
        header.append("total_eff_size")
    header.append("weighted_mean")
    print("\t".join(header))

    for k, (ls, decay) in enumerate(zip(length_scales, decays)):
        row = [f"{decay:.17g}",
               f"{(ls / var_dist if args.by_seq_dist else ls):.17g}",
               f"{(ls if args.by_seq_dist else ls * var_dist):.17g}"]
        wnum = wden = 0.0
        for contig in shared:
            c, eff = phasing_correctness(truth[contig], query[contig], decay,
                                         args.by_seq_dist,
                                         args.cross_block_correct)
            wnum += c * eff
            wden += eff
            if args.report_eff_size:
                row.append(f"{eff:.17g}")
            row.append(f"{c:.17g}")
        if args.report_eff_size:
            row.append(f"{wden:.17g}")
        row.append(f"{(wnum / wden if wden else float('nan')):.17g}")
        print("\t".join(row))
        if (k + 1) % max(1, n // 5) == 0:
            progress(f"Finished computing correctness for {k + 1} of "
                     f"{n} length scales")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
