"""Haploid `margin polish` driver.

Counterpart of the haploid part of `margin_tpu/polish/driver.py`
(`poa_realign_iterative`, `poa_realign_all`, `run_polish` :116-376) with an
explicit `device`. Parity: polish_main (polish.c:87-1014): per chunk,
realign the reads to the chunk's reference with the banded
forward-backward (K2, or K3 for reads over SEG_MIN_D diagonals), build the
POA, call consensus with bubble scoring on the dense forward (K1),
re-estimate run lengths, then stitch the chunk sequences into the polished
FASTA.

Not ported in this slice, each raising NotImplementedError that names its
ROADMAP queue 1 item: diploid polish, HELEN features, the supplementary
POA/repeat-count outputs, VCF-guided polish and multi-host runs. The JAX
package's device-mesh block has no counterpart (one GPU).
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from margin_tpu_torch import _ext
from margin_tpu_torch.io import bam as bamio
from margin_tpu_torch.io.fasta import FastaIndex, write_fasta
from margin_tpu_torch.ops import pairhmm
from margin_tpu_torch.params import Params
from margin_tpu_torch.phase import chunker as chunkermod
from margin_tpu_torch.polish import bubbles_poa, repeats, stitcher
from margin_tpu_torch.polish.poa import Poa, PoaRead, poa_realign
from margin_tpu_torch.polish.reads import convert_to_reads_and_alignments
from margin_tpu_torch.rle import RleString
from margin_tpu_torch.utils import profiling


@dataclass
class PolishOutputs:
    fasta: Optional[str] = None
    sequences: Optional[list] = None


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


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, "
                              f"\"{item}\")")


def run_polish(bam_file: str, reference_fasta: str, params: Params,
               output_base: str, region: Optional[str] = None,
               diploid: bool = False, seed: int = 0, use_lut: bool = False,
               feature_type: Optional[str] = None,
               output_poa_csv: bool = False, output_poa_dot: bool = False,
               output_repeat_counts: bool = False,
               vcf_file: Optional[str] = None,
               checkpoint: bool = False,
               shard: Optional[tuple] = None,
               profiler=None,
               threads: int = 1,
               hosts: Optional[tuple] = None,
               device="cuda",
               log=print) -> PolishOutputs:
    """Haploid polish_main (polish.c:87-1014): BAM + draft FASTA + params in,
    `<output_base>.fa` (and `<output_base>.chunks.csv`) out.

    shard=(i, n) polishes every nth chunk (offset i) into the shared
    checkpoint directory; shard=("merge",) combines. threads>1 runs chunks
    on a host thread pool (polish.c:475-478) with per-chunk RNG streams,
    the same streams as shard mode. device: "cuda" (default) runs the
    kernels on the GPU; "cpu" runs their plain PyTorch twins. CUDA asked
    for and absent raises."""
    if diploid:
        _not_ported("diploid polish (--diploid)", "Diploid polish")
    if feature_type is not None:
        _not_ported("HELEN feature output", "HELEN, EM with K4, and the "
                    "aux tools")
    if output_poa_csv or output_poa_dot or output_repeat_counts:
        _not_ported("supplementary POA / repeat-count outputs",
                    "Diploid polish")
    if vcf_file is not None:
        _not_ported("VCF-guided polish (-v)", "Diploid polish")
    if hosts is not None:
        _not_ported("multi-host polish", "IPC workers, multi-GPU and "
                    "multi-host")
    device = _ext.resolve_device(device)
    bamio.set_cram_reference(reference_fasta)
    profiler = profiler or profiling.NULL
    rng = random.Random(seed)
    shard_idx = shard_n = None
    if shard is not None:
        checkpoint = True
        if shard[0] != "merge":
            shard_idx, shard_n = int(shard[0]), int(shard[1])
    t0 = time.time()
    pp = params.polish

    with profiler.stage("chunker"):
        chunkr = chunkermod.construct_chunker(bam_file, region, None, pp,
                                              record_filtered_reads=False)
    log(f"> Built {len(chunkr.chunks)} chunks")
    with open(f"{output_base}.chunks.csv", "w") as fh:
        for c in chunkr.chunks:   # polish.c:410-418
            fh.write(f"{c.ref_name},{c.chunk_overlap_start},"
                     f"{c.chunk_overlap_end},{c.chunk_start},{c.chunk_end}\n")
    fasta = FastaIndex(reference_fasta)
    tables = pairhmm.PairHmmTables.from_params(
        pp.sm_forward, pp.sm_reverse,
        repeat=pp.repeat_sub_matrix if pp.useRepeatCountsInAlignment else None,
        device=device)

    from margin_tpu_torch.utils.checkpoint import ChunkCheckpointer
    threads = max(int(threads), 1)
    per_chunk_rng = shard is not None or threads > 1
    ckpt = ChunkCheckpointer(
        f"{output_base}.checkpoint", enabled=checkpoint,
        meta={"bam": os.path.abspath(bam_file), "region": region,
              "seed": seed, "diploid": False,
              "n_chunks": len(chunkr.chunks),
              "per_chunk_rng": per_chunk_rng},
        log=log)
    my_chunks = [c for c in chunkr.chunks
                 if shard_idx is None or c.chunk_idx % shard_n == shard_idx]
    ckpt_lock = threading.Lock()

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
        seq_rec = (chunk.ref_name, chunk.chunk_idx, poa.ref_string.expand())
        with ckpt_lock:
            ckpt.save(chunk.chunk_idx, {
                "seq": seq_rec,
                "rng_state": (None if per_chunk_rng
                              else chunk_rng.getstate())})
        log(f"  chunk {chunk.chunk_idx}: {len(reads)} reads, "
            f"consensus {poa.ref_string.non_rle_length}bp")
        return seq_rec

    with profiler.stage("chunks"):
        if threads == 1:
            reader = bamio.open_alignment(bam_file)
            chunk_seqs = []
            for chunk in my_chunks:
                chunk_rng = (random.Random(f"{seed}:{chunk.chunk_idx}")
                             if per_chunk_rng else rng)
                chunk_seqs.append(process_chunk(chunk, reader, chunk_rng))
            reader.close()
        else:
            from concurrent.futures import ThreadPoolExecutor
            tls = threading.local()
            open_readers: list = []

            def worker(chunk):
                reader = getattr(tls, "reader", None)
                if reader is None:
                    reader = tls.reader = bamio.open_alignment(bam_file)
                    with ckpt_lock:
                        open_readers.append(reader)
                return process_chunk(
                    chunk, reader, random.Random(f"{seed}:{chunk.chunk_idx}"))

            with ThreadPoolExecutor(max_workers=threads) as pool:
                chunk_seqs = list(pool.map(worker, my_chunks))
            for r in open_readers:
                r.close()
    if ckpt.loaded:
        log(f"> Resumed {ckpt.loaded} of {len(chunkr.chunks)} chunks "
            f"from checkpoint")
    if shard_idx is not None:
        log(f"> Shard {shard_idx}/{shard_n} complete: "
            f"{len(chunk_seqs)} chunks checkpointed; run with --shard merge "
            f"to produce outputs")
        return PolishOutputs()

    with profiler.stage("stitch"):
        sequences = stitcher.stitch_sequences(chunk_seqs, params, device)
    out = PolishOutputs(fasta=f"{output_base}.fa", sequences=sequences)
    write_fasta(out.fasta, sequences)
    if ckpt.enabled:
        log(f"> {ckpt.report()}")
    ckpt.finalize()
    log(f"> Wrote polished FASTA {out.fasta} in {time.time() - t0:.1f}s")
    return out
