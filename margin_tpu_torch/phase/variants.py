"""Per-chunk variant selection and allele substrings.

Parity:
  - getVcfEntriesForRegion (vcf.c:259-391): binary-searched window, quality
    gates per variant class, adaptive sampling backfill by quality.
  - getAlleleSubstrings2 (vcf.c:394-464): allele strings flanked by
    +-expansion of reference context; refAlnStart/StopIncl window.
"""

from __future__ import annotations

import random
from typing import List, Tuple

from margin_tpu_torch.io.vcf import VcfEntry
from margin_tpu_torch.params import Params
from margin_tpu_torch.rle import RleString


def get_vcf_entries_for_region(vcf_entries_map, ref_name: str, start: int,
                               end: int, params: Params,
                               rng: random.Random,
                               rle_map=None) -> Tuple[List[VcfEntry], List[VcfEntry]]:
    """Returns (primary_entries, filtered_entries); chunk-local copies with
    refPos in 1-based 'POA space' relative to `start`
    (getVcfEntriesForRegion, vcf.c:259-391). `rle_map` is the chunk
    reference's non-RLE-to-RLE coordinate map for the RLE polish path."""
    pp = params.phase
    entries = vcf_entries_map.get(ref_name)
    if entries is None:
        return [], []
    primary: List[VcfEntry] = []
    filtered: List[VcfEntry] = []
    unusable: List[VcfEntry] = []

    # binary search for first index at/after start (vcf.c:238-257)
    import bisect
    positions = [e.ref_pos for e in entries]
    start_idx = bisect.bisect_left(positions, start)

    for i in range(start_idx, len(entries)):
        e = entries[i]
        if e.ref_pos >= end:
            break
        # 1-based POA space, through the RLE map if given (vcf.c:291)
        local = e.ref_pos - start
        ref_pos = (int(rle_map[local]) if rle_map is not None else local) + 1

        is_unusable = False
        if e.is_sv:
            if pp.minSvVariantQuality > e.quality:
                is_unusable = True
        elif e.is_indel:
            if pp.minIndelVariantQuality > e.quality:
                is_unusable = True
        else:
            if pp.minSnpVariantQuality > e.quality:
                is_unusable = True
        if pp.onlyUseSNPVCFEntries and e.is_indel:
            if not (pp.useSVsForPhasing and e.is_sv):
                is_unusable = True

        copy = VcfEntry(e.ref_name, ref_pos, e.raw_ref_pos, e.quality,
                        e.is_indel, e.is_sv,
                        [a.copy() for a in e.alleles], e.gt1, e.gt2,
                        root=e, line_idx=e.line_idx)
        copy.init_read_sets()

        if is_unusable:
            unusable.append(copy)
        elif (pp.useVariantSelectionAdaptiveSampling
              and e.quality < pp.variantSelectionAdaptiveSamplingPrimaryThreshold):
            filtered.append(copy)
        else:
            primary.append(copy)

    # adaptive sampling backfill (vcf.c:343-365)
    desired = (end - start) // pp.variantSelectionAdaptiveSamplingDesiredBasepairsPerVariant
    if pp.useVariantSelectionAdaptiveSampling and len(primary) < desired:
        rng.shuffle(filtered)  # break quality ties randomly (vcf.c:350)
        filtered.sort(key=lambda e: e.quality)  # ascending; pop from end
        while filtered and len(primary) < desired:
            primary.append(filtered.pop())
        primary.sort(key=lambda e: e.ref_pos)

    filtered.extend(unusable)
    filtered.sort(key=lambda e: e.ref_pos)
    return primary, filtered


def get_allele_substrings(entry: VcfEntry, reference_seq: str, params: Params,
                          put_ref_pos_in_poa_space: bool,
                          expansion_override: int = -1):
    """getAlleleSubstrings2 (vcf.c:394-464). Sets
    (substrings, ref_aln_start, ref_aln_stop_incl); positions 0-based unless
    put_ref_pos_in_poa_space."""
    pp = params.phase
    ref_len = len(reference_seq)
    pos = entry.ref_pos - 1  # POA space 1-based -> 0-based

    expansion = pp.referenceExpansionForSmallVariants
    if expansion_override >= 0:
        expansion = expansion_override
    elif entry.is_sv:
        expansion = pp.referenceExpansionForStructuralVariants

    ref_allele = entry.alleles[0].expand()
    ref_allele_len = len(ref_allele)
    if pos + ref_allele_len > ref_len:
        ref_allele_len = max(ref_len - pos, 0)  # deletion past chunk end (vcf.c:415-420)

    p_start = pos - expansion
    s_start = pos + ref_allele_len
    s_len = ref_len - s_start if s_start + expansion >= ref_len else expansion
    if s_start >= ref_len:
        s_start = ref_len - 1
        s_len = 0
    ref_start = max(p_start, 0)
    ref_end_incl = ref_len - 1 if s_start + expansion >= ref_len else s_start + expansion

    prefix = reference_seq[ref_start:ref_start + (pos if p_start < 0 else expansion)]
    suffix = reference_seq[s_start:s_start + s_len]

    use_rle = params.polish.useRunLengthEncoding
    substrings = []
    for allele in entry.alleles:
        full = prefix + allele.expand() + suffix
        substrings.append(RleString.encode(full) if use_rle else RleString.identity(full))

    if put_ref_pos_in_poa_space:
        ref_start += 1
        ref_end_incl += 1
    entry.allele_substrings = substrings
    entry.ref_aln_start = ref_start
    entry.ref_aln_stop_incl = ref_end_incl
    return substrings


def update_vcf_entries_with_substrings(entries: List[VcfEntry], reference_seq: str,
                                       params: Params,
                                       ref_pos_in_poa_space: bool = False):
    """updateVcfEntriesWithSubstringsAndPositions (vcf.c:476-485)."""
    for e in entries:
        get_allele_substrings(e, reference_seq, params, ref_pos_in_poa_space)
