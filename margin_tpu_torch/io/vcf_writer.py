"""Phased-VCF writer + phaseset BED.

Parity: writePhasedVcf (vcf.c:679-1079), updateHaplotypeSwitchingInVcfEntries
(vcf.c:595-650). The original VCF is re-streamed; GT is rewritten
(phased `a|b` or unphased) and a PS FORMAT field appended for phased hets —
matching htslib's bcf_update_genotypes/bcf_update_format_int32 output.
With updateAllOutputVCFFormatFields=true the margin-derived GQ/DP/HQ/HD/
HCPV/HDPV FORMAT fields are also written (vcf.c:725-731, 957-1008).
Multi-sample inputs: records are taken for the first sample only (logged,
vcf.c:718-721); other samples keep their subfields and get "." for any
newly added FORMAT keys.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from margin_tpu_torch.io.vcf import VcfEntry, parse_region, _open_text
from margin_tpu_torch.params import Params


def binomial_pvalue(n: int, k: int) -> float:
    """binomialPValue (bubbleGraph.c:2876-2883): two... one-sided tail
    P(X >= max(k, n-k)) under Binomial(n, 1/2)."""
    if n == 0:
        return 1.0
    k = n - k if k < n / 2 else k
    total = 0
    for i in range(k, n + 1):
        total += math.comb(n, i)
    return total / (2.0 ** n)


def update_haplotype_switching(chunks, switched: List[bool],
                               vcf_entry_map: Dict[str, List[VcfEntry]]):
    """updateHaplotypeSwitchingInVcfEntries (vcf.c:595-650): flip phased
    genotypes of entries in chunks whose phase was switched at stitch."""
    import bisect
    cur_contig = None
    entries = None
    idx = 0
    for i, chunk in enumerate(chunks):
        if cur_contig is None or cur_contig != chunk.ref_name:
            cur_contig = chunk.ref_name
            entries = vcf_entry_map.get(cur_contig)
            if entries is None:
                cur_contig = None
                continue
            positions = [e.ref_pos for e in entries]
            idx = bisect.bisect_left(positions, chunk.chunk_start)
        while idx < len(entries) and entries[idx].ref_pos < chunk.chunk_end:
            e = entries[idx]
            if e.ref_pos >= chunk.chunk_start and switched[i]:
                e.phased_gt1, e.phased_gt2 = e.phased_gt2, e.phased_gt1
                e.haplotype1_prob, e.haplotype2_prob = (e.haplotype2_prob,
                                                        e.haplotype1_prob)
            idx += 1


def _set_gt(parts: List[str], gt_value: str, add_ps: Optional[int],
            extra: Optional[Dict[str, str]] = None):
    """Rewrite the GT subfield of the first sample; optionally append PS and
    further FORMAT fields (`extra`, insertion-ordered). Additional samples
    keep their existing subfields and get "." for newly added keys (the
    reference only takes records for the first sample, vcf.c:718-721)."""
    if len(parts) < 10:
        return parts
    fmt = parts[8].split(":")
    samples = [parts[i].split(":") for i in range(9, len(parts))]
    for sample in samples:
        while len(sample) < len(fmt):
            sample.append(".")

    def set_field(key: str, value: str, insert_front: bool = False):
        if key in fmt:
            samples[0][fmt.index(key)] = value
        elif insert_front:
            fmt.insert(0, key)
            samples[0].insert(0, value)
            for s in samples[1:]:
                s.insert(0, ".")
        else:
            fmt.append(key)
            samples[0].append(value)
            for s in samples[1:]:
                s.append(".")

    set_field("GT", gt_value, insert_front=True)
    for key, value in (extra or {}).items():
        set_field(key, value)
    if add_ps is not None:
        set_field("PS", str(add_ps))
    parts[8] = ":".join(fmt)
    for i, sample in enumerate(samples):
        parts[9 + i] = ":".join(sample)
    return parts


def _to_phred(prob: float) -> int:
    """toPhred (misc.c:139-141): phred of the probability itself, clamped
    to [1e-6, 0.999999] with everything <= 0.1 treated as 1e-6."""
    p = 0.000001 if prob <= 0.1 else (0.999999 if prob >= 0.999999 else prob)
    return int(-10.0 * math.log10(p))


def _unphased_gt(gt1: int, gt2: int) -> str:
    a = "." if gt1 < 0 else str(gt1)
    b = "." if gt2 < 0 else str(gt2)
    return f"{a}/{b}"


def write_phased_vcf(input_vcf: str, region: Optional[str], output_vcf: str,
                     phaseset_bed: Optional[str],
                     vcf_entry_map: Dict[str, List[VcfEntry]], params: Params):
    """writePhasedVcf (vcf.c:679-1079): both the
    updateAllOutputVCFFormatFields=false path (GT+PS only, original
    genotype trusted) and the =true path (GT/GQ/DP/HQ/HD/HCPV/HDPV
    clobbered from the margin analysis, vcf.c:957-1008)."""
    pp = params.phase
    update_all = pp.updateAllOutputVCFFormatFields
    region_contig, region_start, region_end = parse_region(region)

    out = open(output_vcf, "w")
    bed = open(phaseset_bed, "w") if phaseset_bed else None

    header_written = False
    prev_het: Optional[VcfEntry] = None
    cur_entry: Optional[VcfEntry] = None
    phase_set = -1
    next_idx = 0
    cur_chrom = None
    cur_entries: List[VcfEntry] = []
    phase_set_lengths: List[int] = []

    def record_phase_set(reason: str):
        nonlocal phase_set
        if phase_set != -1 and prev_het is not None:
            phase_set_lengths.append(prev_het.ref_pos - phase_set)
            if bed is not None:
                bed.write(f"{prev_het.ref_name}\t{phase_set}\t{prev_het.ref_pos}\t{reason}\n")

    header_lines: List[str] = []
    for line in _open_text(input_vcf):
        if line.startswith("##"):
            header_lines.append(line)
            continue
        if line.startswith("#"):
            # append FORMAT headers (vcf.c:723-733) then the column line
            header_lines.append('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
            header_lines.append('##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase Set Identifier">')
            if update_all:
                header_lines.append('##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality">')
                header_lines.append('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read Depth">')
                header_lines.append('##FORMAT=<ID=HQ,Number=2,Type=Integer,Description="Haplotype Quality">')
                header_lines.append('##FORMAT=<ID=HD,Number=2,Type=Integer,Description="Haplotype Depth">')
                header_lines.append('##FORMAT=<ID=HCPV,Number=2,Type=Integer,Description="Haplotype Concordance with Previous Variant">')
                header_lines.append('##FORMAT=<ID=HDPV,Number=2,Type=Integer,Description="Haplotype Discordance with Previous Variant">')
            n_samples = len(line.rstrip("\n").split("\t")) - 9
            if n_samples > 1:
                import sys
                print(f"> Got {n_samples} samples reading {input_vcf}, will "
                      "only take VCF records for the first", file=sys.stderr)
            seen = set()
            for hl in header_lines:
                key = hl.split(",")[0] if hl.startswith("##FORMAT") else hl
                if key in seen:
                    continue
                seen.add(key)
                out.write(hl + "\n")
            out.write(line + "\n")
            header_written = True
            continue
        if not line.strip():
            continue
        parts = line.split("\t")
        chrom, pos = parts[0], int(parts[1]) - 1
        if region_contig is not None and (chrom != region_contig or
                                          (region_start >= 0 and not (region_start <= pos < region_end))):
            continue

        # original genotype
        orig_gt1 = orig_gt2 = -1
        if len(parts) >= 10:
            fmt = parts[8].split(":")
            sample = parts[9].split(":")
            if "GT" in fmt:
                g = sample[fmt.index("GT")]
                sep = "|" if "|" in g else "/"
                f = g.split(sep)
                if len(f) >= 2 and f[0] not in (".", ""):
                    try:
                        orig_gt1, orig_gt2 = int(f[0]), int(f[1])
                    except ValueError:
                        pass

        skipped = False
        if pp.onlyUsePassVCFEntries and parts[6] not in ("PASS", "."):
            skipped = True
        if not pp.includeHomozygousVCFEntries and orig_gt1 == orig_gt2:
            skipped = True
        if skipped:
            out.write("\t".join(_set_gt(parts, _unphased_gt(orig_gt1, orig_gt2), None)) + "\n")
            continue

        if cur_chrom is None or cur_chrom != chrom:
            record_phase_set("ContigEnd\t")
            cur_chrom = chrom
            cur_entries = vcf_entry_map.get(chrom, [])
            prev_het = None
            cur_entry = None
            next_idx = 0
            phase_set = -1

        # locate the matching entry (vcf.c:820-845)
        next_entry = None
        while next_idx < len(cur_entries):
            cand = cur_entries[next_idx]
            if cand.ref_pos == pos:
                next_idx += 1
                next_entry = cand
                break
            elif cand.ref_pos > pos:
                next_entry = None
                break
            next_idx += 1
        if next_entry is None or not next_entry.was_updated:
            out.write("\t".join(_set_gt(parts, _unphased_gt(orig_gt1, orig_gt2), None)) + "\n")
            continue

        if cur_entry is not None and cur_entry.phased_gt1 != cur_entry.phased_gt2:
            prev_het = cur_entry
        cur_entry = next_entry

        gt1, gt2 = cur_entry.phased_gt1, cur_entry.phased_gt2

        # concordance with previous het (vcf.c:895-911)
        hcpv1 = hcpv2 = hdpv1 = hdpv2 = -1
        determined = False
        if (prev_het is not None and gt1 != gt2 and prev_het.phased_gt1 >= 0
                and gt1 >= 0):
            prev_h1 = prev_het.allele_idx_to_read_ids[prev_het.phased_gt1]
            prev_h2 = prev_het.allele_idx_to_read_ids[prev_het.phased_gt2]
            cur_h1 = cur_entry.allele_idx_to_read_ids[gt1]
            cur_h2 = cur_entry.allele_idx_to_read_ids[gt2]
            hcpv1 = len(prev_h1 & cur_h1)
            hcpv2 = len(prev_h2 & cur_h2)
            hdpv1 = len(prev_h2 & cur_h1)
            hdpv2 = len(prev_h1 & cur_h2)
            determined = True

        # phase set boundary decision (vcf.c:913-945)
        new_phase_set = False
        reason = None
        if gt1 != gt2 and prev_het is None:
            new_phase_set = True
            reason = "NoHet\t"
        elif determined:
            if hcpv1 + hcpv2 < pp.phasesetMinSpanningReads:
                new_phase_set = True
                reason = f"MissingConcordancy\tH1-{hcpv1}_H2-{hcpv2}"
            elif binomial_pvalue(hcpv1 + hcpv2, hcpv1) < pp.phasesetMinBinomialReadSplitLikelihood:
                new_phase_set = True
                pv = binomial_pvalue(hcpv1 + hcpv2, hcpv1)
                reason = f"UnlikelyConcordancy\tH1-{hcpv1}_H2-{hcpv2}_Prob-{pv:.8f}"
            elif (hcpv1 + hcpv2 + hdpv1 + hdpv2) > 0 and \
                    (hdpv1 + hdpv2) / (hcpv1 + hcpv2 + hdpv1 + hdpv2) > pp.phasesetMaxDiscordantRatio:
                new_phase_set = True
                ratio = (hdpv1 + hdpv2) / (hcpv1 + hcpv2 + hdpv1 + hdpv2)
                reason = f"Discordancy\tH1D-{hcpv1}_H2D-{hcpv2}_H1C-{hdpv1}_H2C-{hdpv2}_ratio-{ratio:.4f}"
        if new_phase_set:
            record_phase_set(reason)
            phase_set = pos

        write_ps = gt1 != gt2
        if update_all:
            # vcf.c:957-985: clobber GT and all margin-derived fields
            if gt1 < 0:
                gt_str = "./."
            elif write_ps:
                gt_str = f"{gt1}|{gt2}"
            else:
                gt_str = f"{gt1}/{gt2}"
            depth = 0
            hap1_depth = hap2_depth = -1
            for i, read_ids in enumerate(cur_entry.allele_idx_to_read_ids):
                hp_depth = len(read_ids)
                depth += hp_depth
                if i == gt1:
                    hap1_depth = hp_depth
                if i == gt2:
                    hap2_depth = hp_depth
            extra = {
                "GQ": str(_to_phred(cur_entry.genotype_prob)),
                "HQ": f"{_to_phred(cur_entry.haplotype1_prob)},"
                      f"{_to_phred(cur_entry.haplotype2_prob)}",
                "DP": str(depth),
                "HD": f"{hap1_depth},{hap2_depth}",
            }
            if gt1 != gt2:
                extra["HCPV"] = f"{hcpv1},{hcpv2}"
                extra["HDPV"] = f"{hdpv1},{hdpv2}"
            parts = _set_gt(parts, gt_str, phase_set if write_ps else None,
                            extra)
        else:
            # only trust phasing matching the original call (vcf.c:989-1008)
            if not ((gt1 == orig_gt1 and gt2 == orig_gt2)
                    or (gt1 == orig_gt2 and gt2 == orig_gt1)):
                write_ps = False
            if write_ps:
                parts = _set_gt(parts, f"{gt1}|{gt2}", phase_set)
            else:
                parts = _set_gt(parts, _unphased_gt(orig_gt1, orig_gt2), None)
        out.write("\t".join(parts) + "\n")

    record_phase_set("ContigEnd\t")
    out.close()
    if bed is not None:
        bed.close()
    assert header_written, "input VCF had no header"
    return phase_set_lengths
