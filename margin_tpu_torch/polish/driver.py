"""`margin polish` driver (haploid and diploid).

Counterpart of `margin_tpu/polish/driver.py` (`poa_realign_iterative`,
`poa_realign_all`, `run_polish` :116-376, `run_polish_diploid` :379-763)
with an explicit `device`. Parity: polish_main (polish.c:87-1014): per
chunk, realign the reads to the chunk's reference with the banded
forward-backward (K2, or K3 for reads over SEG_MIN_D diagonals), build the
POA, call consensus with bubble scoring on the dense forward (K1),
re-estimate run lengths, then stitch the chunk sequences into the polished
FASTA, with HELEN features of each chunk's POA on request. Diploid adds
bubble-graph phasing over the POA, per-haplotype consensus, phased
stitching, the haplotagged BAM and, with a truth BAM, the truth
haplotypes' partition. Both modes take chunk threads (-t), checkpoints,
shards (the ground of `--workers process`, parallel/ipc.py) and a
`--hosts` group (parallel/multihost.py); with more than one CUDA device
the bubble scoring is sharded over a device mesh (parallel/executor.py
`auto_mesh`), while the banded forward-backward stays on the tables'
device.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from margin_tpu_torch import _ext
from margin_tpu_torch.io import bam as bamio
from margin_tpu_torch.io.fasta import FastaIndex, write_fasta
from margin_tpu_torch.ops import pairhmm
from margin_tpu_torch.params import Params
from margin_tpu_torch.parallel import executor, multihost
from margin_tpu_torch.phase import chunker as chunkermod
from margin_tpu_torch.phase.downsample import knapsack_probs
from margin_tpu_torch.polish import bubbles_poa, outputs, repeats, stitcher
from margin_tpu_torch.polish.poa import Poa, PoaRead, poa_realign
from margin_tpu_torch.polish.reads import convert_to_reads_and_alignments
from margin_tpu_torch.rle import RleString
from margin_tpu_torch.utils import profiling


@dataclass
class PolishOutputs:
    fasta: Optional[str] = None
    sequences: Optional[list] = None
    hap1_fasta: Optional[str] = None
    hap2_fasta: Optional[str] = None
    haplotagged_bam: Optional[str] = None
    hap1_count: int = 0
    hap2_count: int = 0


def poa_realign_iterative(poa: Poa, reads: List[PoaRead], params: Params,
                          tables, hmm_not_realign: bool,
                          min_iterations: int, max_iterations: int,
                          use_lut: bool = False, profiler=profiling.NULL,
                          chunk_idx: int = 0) -> Poa:
    """poa_realignIterative (poa.c:1876-1952)."""
    pp = params.polish
    score = poa.total_match_weight() - poa.total_error_weight()
    i = 0
    while i < max_iterations:
        i += 1
        if hmm_not_realign:
            with profiler.chunk_stage(chunk_idx, "consensus"):
                reference, poa_to_consensus = poa.get_consensus(pp)
        else:
            with profiler.chunk_stage(chunk_idx, "polish_bubbles"):
                bg = bubbles_poa.bubble_graph_from_poa(
                    poa, reads, None, params, tables, use_lut=use_lut)
                path = bubbles_poa.get_consensus_path(bg)
                reference, poa_to_consensus = \
                    bubbles_poa.get_consensus_string(bg, path, pp)
        if reference == poa.ref_string:
            break
        with profiler.chunk_stage(chunk_idx, "anchors"):
            anchor_alignments = poa.get_anchor_alignments(poa_to_consensus,
                                                          len(reads), pp)
        with profiler.chunk_stage(chunk_idx, "realign"):
            poa2 = poa_realign(reads, anchor_alignments, reference, pp,
                               tables, use_lut=use_lut)
        if pp.useRunLengthEncoding:
            with profiler.chunk_stage(chunk_idx, "repeat_counts"):
                repeats.estimate_repeat_counts(poa2, reads,
                                               pp.repeat_sub_matrix)
        score2 = poa2.total_match_weight() - poa2.total_error_weight()
        if score2 <= score and i > min_iterations:
            break
        poa = poa2
        score = score2
    return poa


def poa_realign_all(reads: List[PoaRead], alignments, reference: RleString,
                    params: Params, tables, use_lut: bool = False,
                    profiler=profiling.NULL, chunk_idx: int = 0) -> Poa:
    """poa_realignAll (poa.c:1955-1975)."""
    pp = params.polish
    with profiler.chunk_stage(chunk_idx, "realign"):
        poa = poa_realign(reads, alignments, reference, pp, tables,
                          use_lut=use_lut)
    if pp.maxPoaConsensusIterations > 0:
        poa = poa_realign_iterative(poa, reads, params, tables, True,
                                    pp.minPoaConsensusIterations,
                                    pp.maxPoaConsensusIterations, use_lut,
                                    profiler, chunk_idx)
    if pp.maxRealignmentPolishIterations > 0:
        poa = poa_realign_iterative(poa, reads, params, tables, False,
                                    pp.minRealignmentPolishIterations,
                                    pp.maxRealignmentPolishIterations,
                                    use_lut, profiler, chunk_idx)
    return poa


def _truth_reads(true_reference_bam: str, chunk, rle_ref, pp):
    """The truth contigs over a chunk as reads named
    CTRID.<chunkIdx>.<name> (misc.c:443-473), with their alignments."""
    import copy
    pp_truth = copy.copy(pp)
    pp_truth.includeSupplementaryAlignments = True
    truth_reader = bamio.open_alignment(true_reference_bam)
    try:
        t_reads, t_alns, _, _ = convert_to_reads_and_alignments(
            chunk, rle_ref, truth_reader, pp_truth, keep_filtered=False)
    finally:
        truth_reader.close()
    for tr in t_reads:
        tr.read_name = f"CTRID.{chunk.chunk_idx}.{tr.read_name}"
    return t_reads, t_alns


def _write_truth_partition(path: str, chunks, ids1, ids2) -> None:
    """chunkTruthHaplotypes_print (misc.c:382-440): each chunk's truth
    contigs by the haplotype they were partitioned into."""
    per_chunk = {c.chunk_idx: ([], []) for c in chunks}
    for hap, ids in ((1, ids1), (2, ids2)):
        for name in ids:
            if not name.startswith("CTRID."):
                continue
            parts = name.split(".")
            per_chunk[int(parts[1])][hap - 1].append(".".join(parts[2:]))
    with open(path, "w") as fh:
        fh.write("#contig\tstartPos\tendPos\toverlapStart\toverlapEnd"
                 "\thap\tsequenceName\n")
        for c in chunks:
            for hap_no, names in enumerate(per_chunk[c.chunk_idx], 1):
                for nm in names:
                    fh.write(f"{c.ref_name}\t{c.chunk_start}\t"
                             f"{c.chunk_end}\t{c.chunk_overlap_start}\t"
                             f"{c.chunk_overlap_end}\t{hap_no}\t{nm}\n")


def _write_chunks_csv(output_base: str, chunkr) -> None:
    """The per-run chunk geometry dump (polish.c:410-418)."""
    with open(f"{output_base}.chunks.csv", "w") as fh:
        for c in chunkr.chunks:
            fh.write(f"{c.ref_name},{c.chunk_overlap_start},"
                     f"{c.chunk_overlap_end},{c.chunk_start},{c.chunk_end}\n")


def _chunk_pool(bam_file, chunks, threads, work, io_lock, seed,
                per_chunk_rng, rng):
    """Run work(chunk, reader, chunk_rng) over the chunks in order: on this
    thread with one reader, or on a pool of `threads` (polish.c:475-478's
    `omp parallel for`) with a reader a thread; the chunk streams are
    random.Random(f"{seed}:{chunk_idx}") when per_chunk_rng (always on the
    pool), else the run's `rng`."""
    if threads == 1:
        reader = bamio.open_alignment(bam_file)
        try:
            return [work(c, reader, random.Random(f"{seed}:{c.chunk_idx}")
                         if per_chunk_rng else rng) for c in chunks]
        finally:
            reader.close()
    from concurrent.futures import ThreadPoolExecutor
    tls = threading.local()
    open_readers: list = []

    def worker(chunk):
        reader = getattr(tls, "reader", None)
        if reader is None:
            reader = tls.reader = bamio.open_alignment(bam_file)
            with io_lock:
                open_readers.append(reader)
        return work(chunk, reader, random.Random(f"{seed}:{chunk.chunk_idx}"))

    try:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            return list(pool.map(worker, chunks))
    finally:
        for r in open_readers:
            r.close()


@multihost.scoped
def run_polish(bam_file: str, reference_fasta: str, params: Params,
               output_base: str, region: Optional[str] = None,
               diploid: bool = False, seed: int = 0, use_lut: bool = False,
               feature_type: Optional[str] = None, feature_max_rl: int = 0,
               true_reference_bam: Optional[str] = None,
               full_feature_output: bool = False,
               output_poa_csv: bool = False, output_poa_dot: bool = False,
               output_repeat_counts: bool = False,
               output_haplotype_reads: bool = False,
               output_phasing_state: bool = False,
               vcf_file: Optional[str] = None,
               only_use_vcf_alleles: bool = False,
               skip_output_fasta: bool = False,
               checkpoint: bool = False,
               shard: Optional[tuple] = None,
               skip_filtered_reads: bool = False,
               skip_realignment: bool = False,
               skip_haplotype_bam: bool = False,
               profiler=None,
               threads: int = 1,
               hosts: Optional[tuple] = None,
               device="cuda",
               log=print) -> PolishOutputs:
    """polish_main (polish.c:87-1014): BAM + draft FASTA + params in,
    `<output_base>.fa` (and `<output_base>.chunks.csv`) out; diploid=True
    runs run_polish_diploid. The haploid path takes no VCF and ignores the
    diploid-only flags, as margin_tpu's does.

    shard=(i, n) polishes every nth chunk (offset i) into the shared
    checkpoint directory; shard=("merge",) combines. threads>1 runs chunks
    on a host thread pool (polish.c:475-478) with per-chunk RNG streams,
    the same streams as shard mode. hosts=(coordinator, N, host_id)
    partitions the chunks across a gloo process group: one all-gather of
    the chunk records, host 0 stitches and writes (not with HELEN
    features, which are per host). device: "cuda" (default) runs the
    kernels on the GPU; "cpu" runs their plain PyTorch twins. CUDA asked
    for and absent raises.

    feature_type (simpleWeight, splitRleWeight or channelRleWeight, with
    aliases) writes HELEN features to `<output_base>.T00.h5`;
    true_reference_bam labels them with the truth (-u) and, in diploid
    mode, partitions the truth haplotypes (polish.c:423-431)."""
    if diploid:
        return run_polish_diploid(
            bam_file, reference_fasta, params, output_base, region=region,
            seed=seed, use_lut=use_lut, output_poa_csv=output_poa_csv,
            output_poa_dot=output_poa_dot,
            output_repeat_counts=output_repeat_counts,
            output_haplotype_reads=output_haplotype_reads,
            output_phasing_state=output_phasing_state, vcf_file=vcf_file,
            only_use_vcf_alleles=only_use_vcf_alleles,
            skip_output_fasta=skip_output_fasta, checkpoint=checkpoint,
            true_reference_bam=true_reference_bam, shard=shard,
            skip_filtered_reads=skip_filtered_reads,
            skip_realignment=skip_realignment,
            skip_haplotype_bam=skip_haplotype_bam, profiler=profiler,
            threads=threads, hosts=hosts, device=device, log=log)
    device = _ext.resolve_device(device)
    bamio.set_cram_reference(reference_fasta)
    profiler = profiler or profiling.NULL
    rng = random.Random(seed)
    if hosts is not None and feature_type is not None:
        raise ValueError("HELEN feature output is per-host; run --hosts "
                         "without -f or shard features separately")
    mh = multihost.join(hosts, log)
    shard_idx = shard_n = None
    if shard is not None:
        checkpoint = True
        if shard[0] != "merge":
            shard_idx, shard_n = int(shard[0]), int(shard[1])
    t0 = time.time()
    pp = params.polish

    helen_h5 = None
    if feature_type is not None:
        from margin_tpu_torch.polish import helen
        feature_type = helen.normalize_feature_type(feature_type)
        # polish.c:374-383: simpleWeight requires non-RLE params, the RLE
        # feature types require RLE params
        if (feature_type == "simpleWeight") == pp.useRunLengthEncoding:
            raise ValueError("Invalid runLengthEncoding parameter because "
                             "of HELEN feature type.")
        if feature_max_rl <= 0:
            feature_max_rl = helen.SPLIT_MAX_RUN_LENGTH_DEFAULT
        # openHelenFeatureHDF5FilesByThreadCount (helenFeatures.c:2782-2790)
        helen_h5 = helen.HelenHDF5File(f"{output_base}.T00.h5")

    with profiler.stage("chunker"):
        chunkr = chunkermod.construct_chunker(bam_file, region, None, pp,
                                              record_filtered_reads=False)
    log(f"> Built {len(chunkr.chunks)} chunks")
    _write_chunks_csv(output_base, chunkr)
    fasta = FastaIndex(reference_fasta)
    tables = pairhmm.PairHmmTables.from_params(
        pp.sm_forward, pp.sm_reverse,
        repeat=pp.repeat_sub_matrix if pp.useRepeatCountsInAlignment else None,
        device=device)

    # several cards: shard the scoring batches over a (dp, sp) mesh
    executor.auto_mesh(device, log=log)

    from margin_tpu_torch.utils.checkpoint import ChunkCheckpointer
    if checkpoint and helen_h5 is not None:
        # the HDF5 feature file is rewritten whole each run, so skipped
        # chunks would lose their features
        log("> Checkpointing disabled: incompatible with HELEN feature output")
        checkpoint = False
    threads = max(int(threads), 1)
    per_chunk_rng = shard is not None or threads > 1 or hosts is not None
    ckpt = ChunkCheckpointer(
        f"{output_base}.checkpoint", enabled=checkpoint,
        meta={"bam": os.path.abspath(bam_file), "region": region,
              "seed": seed, "diploid": False,
              "n_chunks": len(chunkr.chunks),
              "per_chunk_rng": per_chunk_rng},
        log=log)
    my_chunks = [c for c in chunkr.chunks
                 if shard_idx is None or c.chunk_idx % shard_n == shard_idx]
    if mh is not None:
        my_chunks = [c for c in my_chunks
                     if c.chunk_idx % mh.num_hosts() == mh.host_id()]
    io_lock = threading.Lock()  # serializes HELEN output and checkpoints

    def process_chunk(chunk, reader, chunk_rng):
        payload = ckpt.load(chunk.chunk_idx)
        if payload is not None:
            if payload.get("rng_state") is not None:
                chunk_rng.setstate(payload["rng_state"])
            return payload["seq"]
        raw_ref = fasta.fetch(chunk.ref_name, chunk.chunk_overlap_start,
                              chunk.chunk_overlap_end).upper()
        rle_ref = (RleString.encode(raw_ref) if pp.useRunLengthEncoding
                   else RleString.identity(raw_ref))
        with profiler.chunk_stage(chunk.chunk_idx, "readextract"):
            reads, alignments, _fr, _fa = convert_to_reads_and_alignments(
                chunk, rle_ref, reader, pp, keep_filtered=False)
        # downsample (polish.c:536-576, haploid uses downsampleViaReadLikelihood)
        if pp.maxDepth > 0 and reads:
            total_nt = sum(r.rle_read.length for r in reads)
            span = chunk.chunk_overlap_end - chunk.chunk_overlap_start
            if total_nt / span >= pp.maxDepth:
                ratio = pp.maxDepth / (total_nt / span)
                kept_r, kept_a = [], []
                for r, a in zip(reads, alignments):
                    if chunk_rng.random() < ratio:
                        kept_r.append(r)
                        kept_a.append(a)
                reads, alignments = kept_r, kept_a
        with profiler.chunk_stage(chunk.chunk_idx, "poa_realign"):
            poa = poa_realign_all(reads, alignments, rle_ref, params, tables,
                                  use_lut, profiler, chunk.chunk_idx)
        if pp.useRunLengthEncoding:
            with profiler.chunk_stage(chunk.chunk_idx, "repeat_counts"):
                repeats.estimate_repeat_counts(poa, reads,
                                               pp.repeat_sub_matrix)
        if helen_h5 is not None:
            from margin_tpu_torch.polish import helen
            with profiler.chunk_stage(chunk.chunk_idx, "helen"), io_lock:
                helen.handle_helen_features(
                    feature_type, feature_max_rl, helen_h5,
                    full_feature_output, true_reference_bam, rle_ref, params,
                    chunk.chunk_idx, chunk, poa, reads, tables, use_lut, log)
        if output_poa_csv or output_poa_dot or output_repeat_counts:
            outputs.write_supplemental_chunk_information(
                output_base, chunk.chunk_idx, chunk, poa, reads, params,
                output_poa_dot, output_poa_csv, output_repeat_counts)
        seq_rec = (chunk.ref_name, chunk.chunk_idx, poa.ref_string.expand())
        with io_lock:
            ckpt.save(chunk.chunk_idx, {
                "seq": seq_rec,
                "rng_state": (None if per_chunk_rng
                              else chunk_rng.getstate())})
        log(f"  chunk {chunk.chunk_idx}: {len(reads)} reads, "
            f"consensus {poa.ref_string.non_rle_length}bp")
        return seq_rec

    with profiler.stage("chunks"):
        chunk_seqs = _chunk_pool(bam_file, my_chunks, threads, process_chunk,
                                 io_lock, seed, per_chunk_rng, rng)
    if ckpt.loaded:
        log(f"> Resumed {ckpt.loaded} of {len(chunkr.chunks)} chunks "
            f"from checkpoint")
    if helen_h5 is not None:
        helen_h5.close()
        if helen_h5.filename is not None:
            log(f"> Wrote HELEN features to {helen_h5.filename}")
    if shard_idx is not None:
        log(f"> Shard {shard_idx}/{shard_n} complete: "
            f"{len(chunk_seqs)} chunks checkpointed; run with --shard merge "
            f"to produce outputs")
        return PolishOutputs()

    if mh is not None:
        # the one collective: every host's (contig, chunk_idx, consensus)
        # records, the stitch inputs (stitching.c:1573-1588), compressed
        payload = mh.dumps_z(chunk_seqs)
        gathered = mh.allgather_bytes(payload)
        log(f"> Gathered chunk records from {mh.num_hosts()} hosts "
            f"(sent {len(payload)} B, received "
            f"{sum(len(b) for b in gathered)} B)")
        chunk_seqs = [rec for b in gathered for rec in mh.loads_z(b)]
        if mh.host_id() != 0:
            mh.barrier("polish-outputs")
            return PolishOutputs()

    out = PolishOutputs()
    if skip_output_fasta:
        # polish.c --skipOutputFasta: supplementary files only
        if ckpt.enabled:
            log(f"> {ckpt.report()}")
        ckpt.finalize()
        log(f"> Finished (skipped FASTA output) in {time.time() - t0:.1f}s")
    else:
        with profiler.stage("stitch"):
            sequences = stitcher.stitch_sequences(chunk_seqs, params, device)
        out = PolishOutputs(fasta=f"{output_base}.fa", sequences=sequences)
        write_fasta(out.fasta, sequences)
        if ckpt.enabled:
            log(f"> {ckpt.report()}")
        ckpt.finalize()
        log(f"> Wrote polished FASTA {out.fasta} in {time.time() - t0:.1f}s")
    if mh is not None:
        mh.barrier("polish-outputs")
    return out


@multihost.scoped
def run_polish_diploid(bam_file: str, reference_fasta: str, params: Params,
                       output_base: str, region: Optional[str] = None,
                       seed: int = 0, use_lut: bool = False,
                       output_poa_csv: bool = False,
                       output_poa_dot: bool = False,
                       output_repeat_counts: bool = False,
                       output_haplotype_reads: bool = False,
                       output_phasing_state: bool = False,
                       vcf_file: Optional[str] = None,
                       only_use_vcf_alleles: bool = False,
                       skip_output_fasta: bool = False,
                       checkpoint: bool = False,
                       true_reference_bam: Optional[str] = None,
                       shard: Optional[tuple] = None,
                       skip_filtered_reads: bool = False,
                       skip_realignment: bool = False,
                       skip_haplotype_bam: bool = False,
                       profiler=None,
                       threads: int = 1,
                       hosts: Optional[tuple] = None,
                       device="cuda",
                       log=print) -> PolishOutputs:
    """polish_main --diploid (polish.c:620-863): per-chunk bubble phasing +
    per-hap consensus, phased stitching (seam vote + trim both haps),
    phased FASTAs + haplotagged BAM. With `vcf_file`, candidate variant
    positions come from the VCF; `only_use_vcf_alleles` restricts alleles
    to the VCF's (requires non-RLE params and skip_output_fasta,
    polish.c:364-371). true_reference_bam (-u): the truth contigs ride
    along as filtered reads and their partition between the haplotypes is
    written to `<output_base>.truthHaplotypesPartition.tsv`. checkpoint,
    shard, threads and hosts as in run_polish; with hosts the one gather
    carries each chunk's (result, hap1, hap2) records."""
    from margin_tpu_torch.phase.driver import write_haplotagged_bam
    from margin_tpu_torch.phase.stitching import (ChunkPhaseResult,
                                                  stitch_next_chunk)
    from margin_tpu_torch.polish import diploid as diploidmod
    device = _ext.resolve_device(device)
    bamio.set_cram_reference(reference_fasta)
    profiler = profiler or profiling.NULL
    rng = random.Random(seed)
    mh = multihost.join(hosts, log)
    shard_idx = shard_n = None
    if shard is not None:
        checkpoint = True
        if shard[0] != "merge":
            shard_idx, shard_n = int(shard[0]), int(shard[1])
    t0 = time.time()
    pp = params.polish
    if not skip_filtered_reads and not pp.skipHaploidPolishingIfDiploid:
        # polish.c:361-363: only the filtered-read partition path requires
        # the non-mutating POA; with --skipFilteredReads the reference runs
        # the refining poa_realignAll instead
        raise ValueError("Parameter polish->skipHaploidPolishingIfDiploid "
                         "must be TRUE unless skipFilteredReads is set")
    if only_use_vcf_alleles:
        if pp.useRunLengthEncoding:
            raise ValueError("The --onlyVcfAlleles parameter can only be "
                             "used without runLengthEncoding")
        if not skip_output_fasta:
            raise ValueError("The --onlyVcfAlleles parameter must be used "
                             "with the --skipOutputFasta option")

    vcf_entries_map = None
    if vcf_file is not None:
        from margin_tpu_torch.io.vcf import parse_vcf
        vcf_entries_map = parse_vcf(vcf_file, region,
                                    use_rle=pp.useRunLengthEncoding)

    # polish.c:400: filtered reads are only recorded when they will be
    # partitioned afterwards
    with profiler.stage("chunker"):
        chunkr = chunkermod.construct_chunker(
            bam_file, region, None, pp,
            record_filtered_reads=not skip_filtered_reads)
    log(f"> Built {len(chunkr.chunks)} chunks (diploid)")
    _write_chunks_csv(output_base, chunkr)
    fasta = FastaIndex(reference_fasta)
    tables = pairhmm.PairHmmTables.from_params(
        pp.sm_forward, pp.sm_reverse,
        repeat=pp.repeat_sub_matrix if pp.useRepeatCountsInAlignment else None,
        device=device)

    # several cards: shard the scoring batches over a (dp, sp) mesh
    executor.auto_mesh(device, log=log)

    from margin_tpu_torch.utils.checkpoint import ChunkCheckpointer
    threads = max(int(threads), 1)
    per_chunk_rng = shard is not None or threads > 1 or hosts is not None
    ckpt = ChunkCheckpointer(
        f"{output_base}.checkpoint", enabled=checkpoint,
        meta={"bam": os.path.abspath(bam_file), "region": region,
              "seed": seed, "diploid": True, "vcf": vcf_file,
              "n_chunks": len(chunkr.chunks),
              "per_chunk_rng": per_chunk_rng},
        log=log)
    my_chunks = [c for c in chunkr.chunks
                 if shard_idx is None or c.chunk_idx % shard_n == shard_idx]
    if mh is not None:
        my_chunks = [c for c in my_chunks
                     if c.chunk_idx % mh.num_hosts() == mh.host_id()]
    io_lock = threading.Lock()   # serializes the checkpoints

    def process_chunk(chunk, reader, rng):
        payload = ckpt.load(chunk.chunk_idx)
        if payload is not None:
            if payload.get("rng_state") is not None:
                rng.setstate(payload["rng_state"])
            return (payload["res"], payload["hap1_seq"],
                    payload["hap2_seq"])
        raw_ref = fasta.fetch(chunk.ref_name, chunk.chunk_overlap_start,
                              chunk.chunk_overlap_end).upper()
        rle_ref = (RleString.encode(raw_ref) if pp.useRunLengthEncoding
                   else RleString.identity(raw_ref))
        with profiler.chunk_stage(chunk.chunk_idx, "readextract"):
            reads, alignments, f_reads, f_alns = \
                convert_to_reads_and_alignments(chunk, rle_ref, reader, pp,
                                                keep_filtered=True)
            if true_reference_bam is not None:
                # chunkTruthHaplotypes_addTruthReadsToFilteredReadSet
                # (misc.c:443-473): truth contigs ride along as filtered
                # reads with CTRID.<chunkIdx>.<name> names and get
                # partitioned with the phased haplotypes
                t_reads, t_alns = _truth_reads(true_reference_bam, chunk,
                                               rle_ref, pp)
                f_reads.extend(t_reads)
                f_alns.extend(t_alns)
        # downsample via full read length (polish.c:544-549)
        if pp.maxDepth > 0 and reads:
            lengths = np.array([r.rle_read.length for r in reads])
            span = chunk.chunk_overlap_end - chunk.chunk_overlap_start
            if lengths.sum() / span >= pp.maxDepth:
                metrics = np.array([r.full_read_length for r in reads])
                probs = knapsack_probs(lengths, metrics, pp.maxDepth, span)
                kept_r, kept_a = [], []
                for r, a, p in zip(reads, alignments, probs):
                    if rng.random() < p:
                        kept_r.append(r)
                        kept_a.append(a)
                    elif not skip_filtered_reads:
                        # polish.c:530: downsampled-out reads only join the
                        # filtered pool when it will be partitioned
                        f_reads.append(r)
                        f_alns.append(a)
                reads, alignments = kept_r, kept_a
        with profiler.chunk_stage(chunk.chunk_idx, "poa_realign"):
            if skip_realignment:
                # polish.c:591-594: CIGAR-string likelihoods only, POA
                # unmutated
                from margin_tpu_torch.polish.poa import \
                    poa_realign_only_anchor_alignments
                poa = poa_realign_only_anchor_alignments(reads, alignments,
                                                         rle_ref, pp)
            elif pp.skipHaploidPolishingIfDiploid:
                poa = poa_realign(reads, alignments, rle_ref, pp, tables,
                                  use_lut=use_lut)
            else:
                # polish.c:599-601 (reachable only with --skipFilteredReads)
                poa = poa_realign_all(reads, alignments, rle_ref, params,
                                      tables, use_lut, profiler,
                                      chunk.chunk_idx)
        chunk_vcf_entries = None
        if vcf_entries_map is not None:
            # polish.c:630-642
            from margin_tpu_torch.phase import variants
            rle_map = (rle_ref.non_rle_to_rle_map()
                       if pp.useRunLengthEncoding else None)
            chunk_vcf_entries, _filtered = variants.get_vcf_entries_for_region(
                vcf_entries_map, chunk.ref_name, chunk.chunk_overlap_start,
                chunk.chunk_overlap_end, params, rng, rle_map=rle_map)
        want_supplemental = (output_poa_csv or output_poa_dot
                             or output_repeat_counts
                             or output_haplotype_reads
                             or output_phasing_state)
        collect = {} if want_supplemental else None
        with profiler.chunk_stage(chunk.chunk_idx, "diploid"):
            (hap1_seq, hap2_seq, hap1_names, hap2_names, gf, phreds,
             name_by_id) = diploidmod.diploid_chunk(
                poa, reads, f_reads, f_alns, rle_ref, chunk_vcf_entries,
                params, tables, ref_name=chunk.ref_name, use_lut=use_lut,
                collect=collect, only_vcf_alleles=only_use_vcf_alleles,
                output_fasta=not skip_output_fasta, alignments=alignments,
                chunk=chunk, rng=rng, skip_filtered=skip_filtered_reads,
                skip_realignment=skip_realignment, profiler=profiler)
        if want_supplemental:
            # poa_writeSupplementalChunkInformationDiploid
            # (htsIntegration.c:1546-1587)
            for hap_id, key in ((".hap1", "poa_hap1"), (".hap2", "poa_hap2")):
                outputs.write_supplemental_chunk_information(
                    output_base, chunk.chunk_idx, chunk, collect[key], reads,
                    params, output_poa_dot, output_poa_csv,
                    output_repeat_counts, hap_identifier=hap_id)
            if output_haplotype_reads:
                min_phred = params.phase.minPhredScoreForHaplotypePartition
                for hap_id, ids in ((".hap1", collect["hap1_ids"]),
                                    (".hap2", collect["hap2_ids"])):
                    path = outputs._chunk_file_base(
                        output_base, "readIds", chunk.chunk_idx,
                        chunk, hap_id) + ".csv"
                    hap_reads = {r.read_name: phreds.get(id(r), 0.0) or 0.0
                                 for r in reads if id(r) in ids}
                    with open(path, "w") as fh:
                        outputs.write_partition_csv(fh, hap_reads, min_phred)
            if output_phasing_state:
                path = (f"{output_base}.C{chunk.chunk_idx:05d}."
                        f"{chunk.ref_name}-{chunk.chunk_overlap_start}-"
                        f"{chunk.chunk_overlap_end}.phasingInfo.json")
                rle_map = rle_ref.rle_to_non_rle_map()
                with open(path, "w") as fh:
                    fh.write("{\n")
                    outputs.save_bubble_phasing_info(
                        chunk, collect["bg"], gf, collect["hap1_ids"],
                        collect["hap2_ids"], rle_map, fh)
                    outputs.write_phased_read_info_json(
                        chunk, reads, alignments, f_reads, f_alns,
                        collect["hap1_ids"], collect["hap2_ids"],
                        rle_map, fh)
                    fh.write("\n}\n")
        res = ChunkPhaseResult(chunk.chunk_idx, chunk.ref_name)
        for r in reads:
            p = phreds.get(id(r))
            if r.read_name in hap1_names:
                res.hap1_reads[r.read_name] = p if p and p > 0 else -1.0
            elif r.read_name in hap2_names:
                res.hap2_reads[r.read_name] = p if p and p > 0 else -1.0
        for r in f_reads:
            if r.read_name in hap1_names and r.read_name not in res.hap1_reads:
                res.hap1_reads[r.read_name] = -1.0
            elif r.read_name in hap2_names and r.read_name not in res.hap2_reads:
                res.hap2_reads[r.read_name] = -1.0
        with io_lock:
            ckpt.save(chunk.chunk_idx, {
                "res": res, "hap1_seq": hap1_seq, "hap2_seq": hap2_seq,
                "rng_state": None if per_chunk_rng else rng.getstate()})
        log(f"  chunk {chunk.chunk_idx}: {len(reads)} reads -> "
            f"{len(res.hap1_reads)} hap1 / {len(res.hap2_reads)} hap2; "
            f"consensus {len(hap1_seq)}/{len(hap2_seq)}bp")
        return (res, hap1_seq, hap2_seq)

    with profiler.stage("chunks"):
        # (ChunkPhaseResult, hap1_seq, hap2_seq) a chunk
        chunk_results = _chunk_pool(bam_file, my_chunks, threads,
                                    process_chunk, io_lock, seed,
                                    per_chunk_rng, rng)
    if ckpt.loaded:
        log(f"> Resumed {ckpt.loaded} of {len(chunkr.chunks)} chunks "
            f"from checkpoint")
    if shard_idx is not None:
        log(f"> Shard {shard_idx}/{shard_n} complete: "
            f"{len(chunk_results)} chunks checkpointed; run with "
            f"--shard merge to produce outputs")
        return PolishOutputs()

    if mh is not None:
        # one gather of the stitch inputs: each chunk's ChunkPhaseResult
        # (hap read-name maps, switch flag) and its two hap consensus
        # strings, compressed on the wire
        payload = mh.dumps_z(chunk_results)
        gathered = mh.allgather_bytes(payload)
        log(f"> Gathered chunk records from {mh.num_hosts()} hosts "
            f"(sent {len(payload)} B, received "
            f"{sum(len(b) for b in gathered)} B)")
        chunk_results = [rec for b in gathered for rec in mh.loads_z(b)]
        if mh.host_id() != 0:
            mh.barrier("polish-diploid-outputs")
            return PolishOutputs()

    # phased stitch: vote + swap + trim both hap sequences
    # (mergeContigChunkz, stitching.c:1413-1499)
    out = PolishOutputs()
    hap1_records, hap2_records = [], []
    ids1, ids2 = [], []
    with profiler.stage("stitch"):
        chunk_results.sort(key=lambda t: t[0].chunk_idx)
        i = 0
        while i < len(chunk_results):
            name = chunk_results[i][0].ref_name
            j = i
            acc1 = dict(chunk_results[i][0].hap1_reads)
            acc2 = dict(chunk_results[i][0].hap2_reads)
            prev1, prev2 = chunk_results[i][1], chunk_results[i][2]
            pieces1, pieces2 = [], []
            j += 1
            while j < len(chunk_results) \
                    and chunk_results[j][0].ref_name == name:
                res, s1, s2 = chunk_results[j]
                stitch_next_chunk(acc1, acc2, res,
                                  params.phase.stitchWithPrimaryReadsOnly)
                if res.was_switched:
                    s1, s2 = s2, s1
                if not skip_output_fasta:
                    prev1, s1, _ = stitcher.trim_adjacent_sequences(
                        prev1, s1, params, device)
                    prev2, s2, _ = stitcher.trim_adjacent_sequences(
                        prev2, s2, params, device)
                pieces1.append(prev1)
                pieces2.append(prev2)
                prev1, prev2 = s1, s2
                j += 1
            pieces1.append(prev1)
            pieces2.append(prev2)
            hap1_records.append((name, "".join(pieces1)))
            hap2_records.append((name, "".join(pieces2)))
            ids1.extend(acc1.keys())
            ids2.extend(acc2.keys())
            i = j

    if not skip_output_fasta:
        out.hap1_fasta = f"{output_base}.hap1.fa"
        out.hap2_fasta = f"{output_base}.hap2.fa"
        write_fasta(out.hap1_fasta, hap1_records)
        write_fasta(out.hap2_fasta, hap2_records)
    if skip_haplotype_bam:
        # polish.c -M/--skipHaplotypeBAM
        out.hap1_count, out.hap2_count = len(set(ids1)), len(set(ids2))
    else:
        out.haplotagged_bam = f"{output_base}.haplotagged.bam"
        with profiler.stage("haplotag_bam"):
            h1, h2, h0 = write_haplotagged_bam(bam_file, out.haplotagged_bam,
                                               region, set(ids1), set(ids2),
                                               params)
        out.hap1_count, out.hap2_count = h1, h2
    if true_reference_bam is not None:
        path = f"{output_base}.truthHaplotypesPartition.tsv"
        _write_truth_partition(path, chunkr.chunks, ids1, ids2)
        log(f"> Wrote truth haplotype partitioning to {path}")
    if ckpt.enabled:
        log(f"> {ckpt.report()}")
    ckpt.finalize()
    bam_note = ("BAM skipped" if skip_haplotype_bam
                else f"BAM H1 {h1} H2 {h2} H0 {h0}")
    log(f"> Diploid polish done in {time.time() - t0:.1f}s: "
        f"hap lengths {sum(len(s) for _, s in hap1_records)}/"
        f"{sum(len(s) for _, s in hap2_records)}, {bam_note}")
    if mh is not None:
        mh.barrier("polish-diploid-outputs")
    return out
