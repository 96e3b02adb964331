"""tagFromPhasedVcf: haplotag reads directly from an already-phased VCF
(no read-partition HMM; reads vote by allele alignment likelihood).

Copy of `margin_tpu/tools/tag_from_phased_vcf.py` with the port's imports
and `--device {cuda,cpu}`: the allele likelihoods are K1's on a CUDA
device (phasing.score_het_groups), its plain twin's on the CPU.

Parity: tools/tagFromPhasedVcf.c + bubbleGraph_partitionFilteredReadsFromPhasedVcfEntries
(bubbleGraph.c:1945-2136). Chunk stitching runs with doNotSwitch so the
VCF's phasing is preserved across chunk seams."""

from __future__ import annotations

import argparse
import random
import sys
from typing import Dict

import numpy as np

from margin_tpu_torch.io import bam as bamio
from margin_tpu_torch.io.fasta import FastaIndex
from margin_tpu_torch.io.vcf import parse_vcf, mark_svs
from margin_tpu_torch.ops import pairhmm
from margin_tpu_torch.params import Params
from margin_tpu_torch.phase import chunker as chunkermod
from margin_tpu_torch.phase import phasing, variants
from margin_tpu_torch.phase.driver import write_haplotagged_bam
from margin_tpu_torch.phase.readextract import extract_read_substrings_sv_aware
from margin_tpu_torch.phase.stitching import ChunkPhaseResult, stitch_phase_results


def main(argv=None):
    p = argparse.ArgumentParser(prog="tagFromPhasedVcf")
    p.add_argument("bam")
    p.add_argument("reference")
    p.add_argument("vcf", help="phased VCF (GT with | separators)")
    p.add_argument("params")
    p.add_argument("-o", "--outputBase", default="output")
    p.add_argument("-r", "--region", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the allele likelihoods run: 'cuda' "
                        "(default) launches K1, 'cpu' runs its plain "
                        "PyTorch twin")
    args = p.parse_args(argv)
    # a CRAM decodes against the reference given (the drivers register
    # theirs the same way; margin_tpu's tool registers none)
    bamio.set_cram_reference(args.reference)

    params = Params.load(args.params)
    vcf_entries = parse_vcf(args.vcf, args.region,
                            use_rle=params.polish.useRunLengthEncoding,
                            only_pass=params.phase.onlyUsePassVCFEntries,
                            include_homozygous=params.phase.includeHomozygousVCFEntries)
    mark_svs(vcf_entries, params.phase.indelSizeForSVHandling)
    chunkr = chunkermod.construct_chunker(args.bam, args.region,
                                          set(vcf_entries.keys()),
                                          params.polish, True)
    fasta = FastaIndex(args.reference)
    tables = pairhmm.PairHmmTables.from_params(
        params.polish.sm_forward, params.polish.sm_reverse,
        repeat=(params.polish.repeat_sub_matrix
                if params.polish.useRepeatCountsInAlignment else None),
        device=args.device)
    rng = random.Random(0)

    results = []
    reader = bamio.open_alignment(args.bam)
    for chunk in chunkr.chunks:
        chunk_ref = fasta.fetch(chunk.ref_name, chunk.chunk_overlap_start,
                                chunk.chunk_overlap_end)
        primary, _filtered = variants.get_vcf_entries_for_region(
            vcf_entries, chunk.ref_name, chunk.chunk_overlap_start,
            chunk.chunk_overlap_end, params, rng)
        variants.update_vcf_entries_with_substrings(primary, chunk_ref, params)
        reads, _fr = extract_read_substrings_sv_aware(chunk, primary, reader,
                                                      params, keep_filtered=False)
        # score each read's substrings against the VCF's phased alleles
        # (bubbleGraph_partitionFilteredReadsFromPhasedVcfEntries)
        scores1: Dict[int, float] = {id(r): 0.0 for r in reads}
        scores2: Dict[int, float] = {id(r): 0.0 for r in reads}
        entry_subs = phasing._entry_to_read_substrings(reads, params)
        for entry in primary:
            if entry.gt1 == entry.gt2 or entry.gt1 < 0:
                continue
            subs = entry_subs.get(id(entry))
            if not subs:
                continue
            subs = list(reversed(subs))
            supports = phasing._score_het_bubble(
                entry.allele_substrings[entry.gt1],
                entry.allele_substrings[entry.gt2], subs, params, tables)
            for rs, (sa, sb) in zip(subs, supports.astype(np.float64)):
                tot = np.logaddexp(sa, sb)
                scores1[id(rs.read)] += sa - tot
                scores2[id(rs.read)] += sb - tot
        res = ChunkPhaseResult(chunk.chunk_idx, chunk.ref_name,
                               do_not_switch=True)
        for r in reads:
            s1, s2 = scores1[id(r)], scores2[id(r)]
            if s1 > s2:
                res.hap1_reads[r.read_name] = -1.0
            elif s2 > s1:
                res.hap2_reads[r.read_name] = -1.0
        results.append(res)
        print(f"  chunk {chunk.chunk_idx}: {len(res.hap1_reads)} hap1 / "
              f"{len(res.hap2_reads)} hap2 of {len(reads)} reads")
    reader.close()

    ids1, ids2, _sw = stitch_phase_results(
        results, primary_only=params.phase.stitchWithPrimaryReadsOnly)
    h1, h2, h0 = write_haplotagged_bam(args.bam, f"{args.outputBase}.haplotagged.bam",
                                       args.region, set(ids1), set(ids2), params,
                                       print)
    print(f"Wrote {args.outputBase}.haplotagged.bam: H1 {h1}, H2 {h2}, H0 {h0}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
