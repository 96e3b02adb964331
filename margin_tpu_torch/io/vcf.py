"""VCF reading and phased-VCF writing.

Host-side replacement for the htslib bcf usage in the reference
(impl/vcf.c). Text and BGZF-compressed VCFs are supported; the parse
semantics mirror parseVcf2 (vcf.c:89-228):
  - region filter on contig (+ optional [start, end) window on POS)
  - keep only PASS (or '.') records when onlyUsePassVCFEntries
  - genotype from the FIRST sample's GT; skip homozygous unless configured
  - NaN quality -> 0
  - isIndel = not all alleles length 1; isSV when any allele exceeds
    indelSizeForSVHandling (when that param > 0)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from margin_tpu_torch.io.bgzf import BgzfReader, is_bgzf
from margin_tpu_torch.rle import RleString


@dataclass
class VcfEntry:
    """One kept VCF record (vcfEntry_construct, vcf.c:12-37).

    refPos is 0-based here at parse time; chunk-local copies are converted
    to 1-based "POA space" (getVcfEntriesForRegion, vcf.c:291)."""
    ref_name: str
    ref_pos: int
    raw_ref_pos: int
    quality: float
    is_indel: bool
    is_sv: bool
    alleles: List[RleString]
    gt1: int
    gt2: int
    # filled per chunk:
    allele_substrings: Optional[List[RleString]] = None
    ref_aln_start: int = -1
    ref_aln_stop_incl: int = -1
    root: Optional["VcfEntry"] = None
    # phasing results (written back to root entries):
    was_updated: bool = False
    phased_gt1: int = -1
    phased_gt2: int = -1
    genotype_prob: float = -1.0
    haplotype1_prob: float = -1.0
    haplotype2_prob: float = -1.0
    allele_idx_to_read_ids: Optional[List[set]] = None
    # stitching switch state
    switched: bool = False
    # source line info for the writer
    line_idx: int = -1

    def init_read_sets(self):
        self.allele_idx_to_read_ids = [set() for _ in self.alleles]


def _open_text(path: str):
    from margin_tpu_torch.io.bcf import BcfReader, is_bcf
    if is_bcf(path):  # binary BCF (must test before generic BGZF text)
        return BcfReader(path).lines()
    if is_bgzf(path):
        rd = BgzfReader(path)

        def lines():
            buf = b""
            while True:
                chunk = rd.read(1 << 20)
                if not chunk:
                    break
                buf += chunk
                while True:
                    i = buf.find(b"\n")
                    if i < 0:
                        break
                    yield buf[:i].decode("utf-8")
                    buf = buf[i + 1:]
            if buf:
                yield buf.decode("utf-8")
        return lines()
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":  # plain (non-BGZF) gzip
        import gzip
        fh = gzip.open(path, "rt")
    else:
        fh = open(path)
    return (line.rstrip("\n") for line in fh)


def parse_region(region: Optional[str]):
    """'chr' or 'chr:start-end' (phase.c/vcf.c region handling)."""
    if region is None:
        return None, -1, -1
    if ":" in region:
        contig, rng = region.split(":", 1)
        start_s, end_s = rng.split("-", 1)
        start, end = int(start_s), int(end_s)
        if start < 0 or end < start:
            raise ValueError(f"Bad region: {region}")
        return contig, start, end
    return region, -1, -1


def parse_vcf(path: str, region: Optional[str], *, use_rle: bool,
              only_pass: bool = True, include_homozygous: bool = False) -> Dict[str, List[VcfEntry]]:
    """parseVcf2 (vcf.c:89-228): per-contig position-sorted entry lists."""
    region_contig, region_start, region_end = parse_region(region)
    entries: Dict[str, List[VcfEntry]] = {}
    kept = 0
    line_idx = 0
    for line in _open_text(path):
        if not line or line.startswith("#"):
            continue
        line_idx += 1
        parts = line.split("\t")
        if len(parts) < 8:
            continue
        chrom, pos_s, _id, ref, alt, qual_s, filt = parts[:7]
        pos = int(pos_s) - 1
        if region_contig is not None:
            if chrom != region_contig:
                continue
            if region_start >= 0 and not (region_start <= pos < region_end):
                continue
        if only_pass and filt not in ("PASS", "."):
            continue
        # genotype of first sample
        gt1 = gt2 = -1
        if len(parts) >= 10:
            fmt = parts[8].split(":")
            sample = parts[9].split(":")
            if "GT" in fmt:
                gt_str = sample[fmt.index("GT")]
                sep = "|" if "|" in gt_str else "/"
                fields = gt_str.split(sep)
                if len(fields) >= 2 and fields[0] not in (".", ""):
                    try:
                        gt1, gt2 = int(fields[0]), int(fields[1])
                    except ValueError:
                        gt1 = gt2 = -1
        if not include_homozygous and gt1 == gt2:
            continue
        qual = 0.0 if qual_s == "." else float(qual_s)
        if math.isnan(qual):
            qual = 0.0
        allele_strs = [ref] + alt.split(",")
        alleles = [RleString.encode(a) if use_rle else RleString.identity(a)
                   for a in allele_strs]
        # bcf_is_snp semantics: every allele is a single character
        is_snp = all(len(a) == 1 for a in allele_strs)
        entry = VcfEntry(chrom, pos, pos, qual, not is_snp, False, alleles,
                         gt1, gt2, line_idx=line_idx)
        entry.init_read_sets()
        entries.setdefault(chrom, []).append(entry)
        kept += 1
    if kept == 0:
        raise ValueError("No valid VCF entries found!")
    for lst in entries.values():
        lst.sort(key=lambda e: e.ref_pos)
    return entries


def mark_svs(entries: Dict[str, List[VcfEntry]], indel_size_for_sv: int):
    if indel_size_for_sv <= 0:
        return
    for lst in entries.values():
        for e in lst:
            e.is_sv = any(a.non_rle_length > indel_size_for_sv for a in e.alleles)
