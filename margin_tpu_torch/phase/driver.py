"""`margin phase` driver: chunked, device-batched phasing pipeline.

Parity: phase_main (phase.c:56-570). Chunks are processed independently
(sequentially, on a host thread pool or in shard processes, or
partitioned across a `--hosts` group) and stitched with the cis/trans
phase vote. Pair scoring runs on one device or, with more than one CUDA
device, sharded over a device mesh (parallel/executor.py `auto_mesh`).
Counterpart of `margin_tpu/phase/driver.py` with an explicit `device`.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from margin_tpu_torch import _ext
from margin_tpu_torch.io import bam as bamio
from margin_tpu_torch.io.fasta import FastaIndex
from margin_tpu_torch.io.vcf import parse_vcf, mark_svs
from margin_tpu_torch.io.vcf_writer import update_haplotype_switching, write_phased_vcf
from margin_tpu_torch.ops import pairhmm
from margin_tpu_torch.params import Params
from margin_tpu_torch.parallel import executor, multihost
from margin_tpu_torch.phase import chunker as chunkermod
from margin_tpu_torch.phase import phasing, variants
from margin_tpu_torch.phase.downsample import downsample_reads_by_vcf_spans
from margin_tpu_torch.phase.readextract import extract_read_substrings_sv_aware
from margin_tpu_torch.phase.stitching import ChunkPhaseResult, stitch_phase_results
from margin_tpu_torch.utils import profiling


@dataclass
class PhaseOutputs:
    haplotagged_bam: Optional[str] = None
    phased_vcf: Optional[str] = None
    phaseset_bed: Optional[str] = None
    chunks_csv: Optional[str] = None
    hap1_count: int = 0
    hap2_count: int = 0
    untagged_count: int = 0
    phased_het_count: int = 0


@multihost.scoped
def run_phase(bam_file: str, reference_fasta: str, vcf_file: str,
              params: Params, output_base: str, region: Optional[str] = None,
              write_bam: bool = True, write_vcf: bool = True,
              seed: int = 0, use_lut: bool = False,
              checkpoint: bool = False,
              shard: Optional[tuple] = None,
              profiler: profiling.Profiler = profiling.NULL,
              rng_mode: str = "st",
              threads: int = 1,
              hosts: Optional[tuple] = None,
              device="cuda",
              log=print) -> PhaseOutputs:
    """End-to-end phase pipeline (phase.c:56-570). With checkpoint=True,
    per-chunk results are persisted under <output_base>.checkpoint/ and a
    rerun resumes from the completed chunks.

    shard=(i, n) runs only chunks with idx % n == i into the shared
    checkpoint directory and exits without producing outputs — the
    multi-host scaling mode: launch one process (or host) per shard
    against the same output base, then run once without `shard` to merge.
    Shard mode uses a per-chunk-seeded RNG so chunks are independent of
    processing order (the sequential default keeps the reference-style
    single stream).

    threads>1 processes chunks with a host thread pool (phase.c:276-279's
    `omp parallel for`): host-side work (BAM decode, read extraction, the
    partition HMM) overlaps device batches from other chunks. Like the
    reference under -tN the single RNG stream no longer applies, but where
    the reference becomes nondeterministic, here each chunk draws from its
    own chunk-seeded stream — identical to shard mode, so a threaded run
    equals the same run sharded (deterministic at any thread count).

    hosts=(coordinator, N, host_id) partitions the chunks by index across
    a gloo process group (parallel/multihost.py): one compressed
    all-gather of the chunk results and VCF interior snapshots, then host
    0 writes the outputs; the group is destroyed when the run ends.

    device: "cuda" (default) runs the scoring kernels on the GPU; "cpu"
    runs their plain PyTorch twins. CUDA asked for and absent raises.

    rng_mode="st" (default) draws from a bit-exact glibc rand() replica
    seeded like the unseeded reference binary, consumed in the reference's
    chunk order (size-desc, phase.c:257-262) — making the downsampling
    Bernoulli stream identical to `margin phase` -t1 and the golden
    outputs exact. rng_mode="python" keeps a seeded random.Random."""
    device = _ext.resolve_device(device)
    bamio.set_cram_reference(reference_fasta)
    from margin_tpu_torch.utils.strandom import GlibcRandom, make_rng
    rng = make_rng(rng_mode, seed)
    # chunk-seeded RNG keeps any partitioning across hosts byte-identical
    # to a single-host run with the same streams
    mh = multihost.join(hosts, log)
    shard_idx = shard_n = None
    if shard is not None:
        checkpoint = True
        if shard[0] != "merge":
            shard_idx, shard_n = int(shard[0]), int(shard[1])
            if not 0 <= shard_idx < shard_n:
                raise ValueError(f"bad shard {shard}")
    threads = max(int(threads), 1)
    per_chunk_rng = shard is not None or threads > 1 or hosts is not None
    t0 = time.time()
    out = PhaseOutputs()

    # parse VCF (vcf.c:89-228)
    with profiler.stage("vcf_parse"):
        vcf_entries = parse_vcf(
            vcf_file, region,
            use_rle=params.polish.useRunLengthEncoding,
            only_pass=params.phase.onlyUsePassVCFEntries,
            include_homozygous=params.phase.includeHomozygousVCFEntries)
    mark_svs(vcf_entries, params.phase.indelSizeForSVHandling)
    log(f"> Parsed VCF: {sum(len(v) for v in vcf_entries.values())} kept entries "
        f"on {len(vcf_entries)} contigs")

    # chunker (htsIntegration.c:203-396)
    with profiler.stage("chunker"):
        chunkr = chunkermod.construct_chunker(bam_file, region,
                                              set(vcf_entries.keys()),
                                              params.polish,
                                              record_filtered_reads=True)
    log(f"> Built {len(chunkr.chunks)} chunks (size {params.polish.chunkSize}, "
        f"boundary {params.polish.chunkBoundary})")
    if not chunkr.chunks:
        raise RuntimeError("Found no valid reads!")

    out.chunks_csv = f"{output_base}.chunks.csv"
    with open(out.chunks_csv, "w") as fh:
        for c in chunkr.chunks:
            fh.write(f"{c.ref_name},{c.chunk_overlap_start},{c.chunk_overlap_end},"
                     f"{c.chunk_start},{c.chunk_end}\n")

    fasta = FastaIndex(reference_fasta)
    tables = pairhmm.PairHmmTables.from_params(
        params.polish.sm_forward, params.polish.sm_reverse,
        repeat=(params.polish.repeat_sub_matrix
                if params.polish.useRepeatCountsInAlignment else None),
        device=device)

    # several cards: shard the scoring batches over a (dp, sp) mesh. A
    # process worker scores over its socket, on the parent's device.
    if not executor.has_ipc_client():
        executor.auto_mesh(device, log=log)

    from margin_tpu_torch.utils.checkpoint import (ChunkCheckpointer,
                                             apply_vcf_snapshot,
                                             snapshot_vcf_entries)
    ckpt = ChunkCheckpointer(
        f"{output_base}.checkpoint", enabled=checkpoint,
        meta={"bam": os.path.abspath(bam_file), "vcf": os.path.abspath(vcf_file),
              "region": region, "seed": seed, "n_chunks": len(chunkr.chunks),
              "per_chunk_rng": per_chunk_rng, "rng_mode": rng_mode},
        log=log)

    results: List[ChunkPhaseResult] = []
    t_setup = time.time() - t0
    t_chunks = 0.0

    # chunk ordering (phase.c:252-269): size_desc sorts by estimated depth
    # ascending then reverses (ties end up in descending index order);
    # 'random' shuffles with the run RNG like stList_shuffle
    ordered_chunks = list(chunkr.chunks)
    if params.polish.shuffleChunks:
        if params.polish.shuffleChunksMethod == "size_desc":
            ordered_chunks.sort(key=lambda c: c.estimated_depth)
            ordered_chunks.reverse()
        elif params.polish.shuffleChunksMethod == "random":
            rng.shuffle(ordered_chunks)

    if shard_idx is not None:
        ordered_chunks = [c for c in ordered_chunks
                          if c.chunk_idx % shard_n == shard_idx]
    if mh is not None:
        ordered_chunks = [c for c in ordered_chunks
                          if c.chunk_idx % mh.num_hosts() == mh.host_id()]

    def make_chunk_rng(chunk_idx: int):
        if not per_chunk_rng:
            return rng
        if rng_mode == "st":
            return GlibcRandom(1_000_003 * (seed + 1) + chunk_idx)
        return random.Random(f"{seed}:{chunk_idx}")

    ckpt_lock = __import__("threading").Lock()

    def process_chunk(chunk, reader):
        payload = ckpt.load(chunk.chunk_idx)
        if payload is not None:
            with ckpt_lock:
                apply_vcf_snapshot(vcf_entries, chunk.ref_name,
                                   payload["vcf"])
                if payload.get("rng_state") is not None:
                    rng.setstate(payload["rng_state"])
            return payload["res"]
        res = phase_one_chunk(chunk, reader, fasta, vcf_entries, chunkr,
                              params, tables, make_chunk_rng(chunk.chunk_idx),
                              write_bam, use_lut, log, profiler=profiler)
        # snapshot only the chunk INTERIOR: update_original_vcf_entries
        # writes roots in [chunk_start, chunk_end) only, and snapshots
        # of the wider overlap window would clobber a neighbor chunk's
        # interior when replayed out of order (shard/threaded mode)
        with ckpt_lock:
            ckpt.save(chunk.chunk_idx, {
                "res": res,
                "vcf": snapshot_vcf_entries(vcf_entries, chunk.ref_name,
                                            chunk.chunk_start,
                                            chunk.chunk_end),
                "rng_state": (None if per_chunk_rng else rng.getstate())})
        return res

    t_c = time.time()
    if threads == 1:
        reader = bamio.open_alignment(bam_file)
        for chunk in ordered_chunks:
            results.append(process_chunk(chunk, reader))
        reader.close()
    else:
        # phase.c:276-279 `omp parallel for schedule(dynamic,1)`: a host
        # thread pool; every worker owns a BamReader (seek state is not
        # shareable). vcf_entries cross-thread discipline: workers only
        # write root entries inside their own chunk interior and only read
        # positional fields other chunks never touch.
        import threading as _threading
        from concurrent.futures import ThreadPoolExecutor
        tls = _threading.local()
        open_readers: List = []

        def worker(chunk):
            reader = getattr(tls, "reader", None)
            if reader is None:
                reader = tls.reader = bamio.open_alignment(bam_file)
                with ckpt_lock:
                    open_readers.append(reader)
            return chunk.chunk_idx, process_chunk(chunk, reader)

        with ThreadPoolExecutor(max_workers=threads) as pool:
            by_idx = dict(pool.map(worker, ordered_chunks))
        for r in open_readers:
            r.close()
        # keep the deterministic processing-order result list
        results = [by_idx[c.chunk_idx] for c in ordered_chunks]
    t_chunks = time.time() - t_c
    if ckpt.loaded:
        log(f"> Resumed {ckpt.loaded} of {len(chunkr.chunks)} chunks "
            f"from checkpoint")

    if shard_idx is not None:
        done = len(results)
        log(f"> Shard {shard_idx}/{shard_n} complete: {done} chunks "
            f"checkpointed; run once more without a shard index to merge")
        return out

    if mh is not None:
        # the one collective: every host's chunk results and the VCF
        # interior snapshots the writer needs (stitching.c:1573-1588's
        # merge inputs), compressed on the wire; host 0 writes
        with profiler.stage("host_gather"):
            payload = mh.dumps_z({
                "results": results,
                "vcf": [(c.ref_name,
                         snapshot_vcf_entries(vcf_entries, c.ref_name,
                                              c.chunk_start, c.chunk_end))
                        for c in ordered_chunks],
            })
            gathered_b = mh.allgather_bytes(payload)
            gathered = [mh.loads_z(b) for b in gathered_b]
        results = []
        for hid, p in enumerate(gathered):
            results.extend(p["results"])
            if hid != mh.host_id():
                for ref_name, snap in p["vcf"]:
                    apply_vcf_snapshot(vcf_entries, ref_name, snap)
        log(f"> Gathered {len(results)} chunk results from "
            f"{mh.num_hosts()} hosts (sent {len(payload)} B, received "
            f"{sum(len(b) for b in gathered_b)} B)")
        if mh.host_id() != 0:
            mh.barrier("phase-outputs")
            return out

    # stitch (stitching.c:1558-1693) — results back in genomic chunk order
    results.sort(key=lambda r: r.chunk_idx)
    with profiler.stage("stitch"):
        ids1, ids2, switched = stitch_phase_results(
            results, primary_only=params.phase.stitchWithPrimaryReadsOnly)
    log(f"> Stitched {len(results)} chunks: {len(ids1)} hap1 reads, "
        f"{len(ids2)} hap2 reads, {sum(switched)} chunk switches")

    # haplotagged BAM (htsIntegration.c:1310-1503)
    if write_bam:
        out.haplotagged_bam = f"{output_base}.haplotagged.bam"
        with profiler.stage("write_bam"):
            h1, h2, h0 = write_haplotagged_bam(
                bam_file, out.haplotagged_bam, region,
                set(ids1), set(ids2), params)
        out.hap1_count, out.hap2_count, out.untagged_count = h1, h2, h0
        log(f"> Wrote haplotagged BAM: H1 {h1}, H2 {h2}, H0 {h0}")

    # phased VCF (vcf.c:595-650, 679-1079)
    if write_vcf:
        out.phased_vcf = f"{output_base}.phased.vcf"
        out.phaseset_bed = f"{output_base}.phaseset.bed"
        with profiler.stage("write_vcf"):
            update_haplotype_switching(chunkr.chunks, switched, vcf_entries)
            ps_lengths = write_phased_vcf(vcf_file, region, out.phased_vcf,
                                          out.phaseset_bed, vcf_entries,
                                          params)
        with open(out.phased_vcf) as fh:
            out.phased_het_count = sum(
                1 for line in fh
                if not line.startswith("#") and ("1|0" in line or "0|1" in line))
        log(f"> Wrote phased VCF ({out.phased_het_count} phased 0/1 hets)")
        # end-of-run phase-set summary (vcf.c:1038-1061)
        if ps_lengths:
            lengths = sorted(ps_lengths)
            total = sum(lengths)
            n50 = 0
            acc = 0
            for ln in lengths:
                acc += ln
                if acc > total / 2:
                    n50 = ln
                    break
            log(f"> Identified {len(lengths)} phase sets with lengths "
                f"avg:{total // len(lengths)}, min:{lengths[0]}, "
                f"max:{lengths[-1]}, N50:{n50}")

    if mh is not None:
        mh.barrier("phase-outputs")
    if ckpt.enabled:
        log(f"> {ckpt.report()}")
    ckpt.finalize()
    total_t = time.time() - t0
    t_output = total_t - t_setup - t_chunks
    log(f"> Finished phasing in {total_t:.1f}s "
        f"(setup {t_setup:.1f}s, chunks {t_chunks:.1f}s, "
        f"outputs {t_output:.1f}s)")
    profiler.log_summary(log)
    return out


def phase_one_chunk(chunk, reader, fasta, vcf_entries, chunkr, params, tables,
                    rng, write_bam, use_lut, log,
                    profiler: profiling.Profiler = profiling.NULL
                    ) -> ChunkPhaseResult:
    """One iteration of the phase.c:279-473 chunk loop."""
    res = ChunkPhaseResult(chunk.chunk_idx, chunk.ref_name)
    ci = chunk.chunk_idx

    chunk_ref = fasta.fetch(chunk.ref_name, chunk.chunk_overlap_start,
                            chunk.chunk_overlap_end)

    with profiler.chunk_stage(ci, "variants"):
        primary, filtered_entries = variants.get_vcf_entries_for_region(
            vcf_entries, chunk.ref_name, chunk.chunk_overlap_start,
            chunk.chunk_overlap_end, params, rng)

        variants.update_vcf_entries_with_substrings(primary, chunk_ref,
                                                    params)
        if not params.phase.phasePrimaryVariantsOnly:
            variants.update_vcf_entries_with_substrings(filtered_entries,
                                                        chunk_ref, params)

    with profiler.chunk_stage(ci, "readextract"):
        from margin_tpu_torch.phase.readextract import PrefetchedChunkReader
        chunk_reader = PrefetchedChunkReader(reader, chunk)
        reads, filtered_reads = extract_read_substrings_sv_aware(
            chunk, primary, chunk_reader, params)
        if not params.phase.phasePrimaryVariantsOnly:
            reads_for_filtered, _ = extract_read_substrings_sv_aware(
                chunk, filtered_entries, chunk_reader, params)
        else:
            reads_for_filtered = []

    # downsample (phase.c:360-382)
    if params.polish.maxDepth > 0:
        reads, discarded, did = downsample_reads_by_vcf_spans(
            params.polish.maxDepth, len(primary), reads, rng)
        if did:
            filtered_reads.extend(discarded)

    # bubble graph + phasing
    with profiler.chunk_stage(ci, "bubble_scoring"):
        bg, entries_to_bubbles = phasing.build_bubble_graph(
            reads, primary, params, tables, use_lut=use_lut)
    with profiler.chunk_stage(ci, "rphmm"):
        ref = phasing.get_reference(bg, chunk.ref_name, params)
        gf, pseqs = phasing.phase_bubble_graph(bg, ref, reads, params,
                                               tables.device)
        hap1_ids, hap2_ids, phreds = phasing.phase_bam_chunk_reads(
            gf, pseqs, reads, params)

    log(f"  chunk {chunk.chunk_idx}: {len(primary)} primary vars, "
        f"{len(reads)} reads -> {len(hap1_ids)} hap1 / {len(hap2_ids)} hap2 "
        f"({len(reads) - len(hap1_ids) - len(hap2_ids)} unphased)")

    # phase filtered variants (phase.c:411-416)
    hap1_names = {r.read_name for r in reads if id(r) in hap1_ids}
    hap2_names = {r.read_name for r in reads if id(r) in hap2_ids}
    if not params.phase.phasePrimaryVariantsOnly:
        with profiler.chunk_stage(ci, "filtered_variants"):
            phasing.phase_filtered_vcf_entries(
                reads_for_filtered, filtered_entries, hap1_names, hap2_names,
                chunk, chunkr.read_enumerator, params, tables)

    # unassigned primary reads join the filtered pool (phase.c:419-425)
    for r in reads:
        if id(r) not in hap1_ids and id(r) not in hap2_ids:
            filtered_reads.append(r)

    # partition filtered reads (phase.c:428-436)
    if write_bam:
        filt_h1: set = set()
        filt_h2: set = set()
        with profiler.chunk_stage(ci, "partition_filtered"):
            phasing.partition_filtered_reads(filtered_reads, gf, bg,
                                             entries_to_bubbles, filt_h1,
                                             filt_h2, params, tables)
    else:
        filt_h1, filt_h2 = set(), set()

    # chunk output record (stitching.c:875-925): reads with phred probs,
    # filtered/partitioned reads with -1
    for r in reads:
        if id(r) in hap1_ids:
            p = phreds[id(r)]
            if p > params.phase.minPhredScoreForHaplotypePartition:
                res.hap1_reads[r.read_name] = p
            else:
                res.hap1_reads[r.read_name] = -1.0
        elif id(r) in hap2_ids:
            p = phreds[id(r)]
            if p > params.phase.minPhredScoreForHaplotypePartition:
                res.hap2_reads[r.read_name] = p
            else:
                res.hap2_reads[r.read_name] = -1.0
    for r in filtered_reads:
        if id(r) in filt_h1 and r.read_name not in res.hap1_reads:
            res.hap1_reads[r.read_name] = -1.0
        elif id(r) in filt_h2 and r.read_name not in res.hap2_reads:
            res.hap2_reads[r.read_name] = -1.0

    # update root VCF entries (vcf.c:511-592)
    phasing.update_original_vcf_entries(chunk, reads, chunkr.read_enumerator,
                                        gf, bg, entries_to_bubbles,
                                        hap1_ids, hap2_ids)
    return res


def write_haplotagged_bam(bam_in: str, bam_out: str, region: Optional[str],
                          hap1_names: set, hap2_names: set, params: Params):
    """writeHaplotaggedBam (htsIntegration.c:1310-1503). Uses the native
    marginio engine when built; pure-Python fallback otherwise."""
    from margin_tpu_torch.io.vcf import parse_region
    region_contig, region_start, region_end = parse_region(region)

    sync = params.polish.synchronizeSupplementaryAlignments
    sync_len1: Dict[str, int] = {}
    sync_len2: Dict[str, int] = {}
    if sync:
        # synchronizeReadHaplotags (htsIntegration.c:1219-1308): vote each
        # ORIGINAL read name's haplotype by total mapped length across its
        # (supplementary) alignments
        with bamio.open_alignment(bam_in) as reader:
            for rec in reader:
                if rec.l_seq <= 0 or len(rec.cigar) == 0 or rec.is_unmapped:
                    continue
                if not params.polish.includeSecondaryAlignments and rec.is_secondary:
                    continue
                if not params.polish.includeSupplementaryAlignments and rec.is_supplementary:
                    continue
                fragment = chunkermod.get_read_name(
                    rec, reader.header.ref_names[rec.ref_id])
                in1 = fragment in hap1_names
                in2 = fragment in hap2_names
                if in1 and not in2:
                    sync_len1[rec.name] = sync_len1.get(rec.name, 0) + rec.l_seq
                elif in2 and not in1:
                    sync_len2[rec.name] = sync_len2.get(rec.name, 0) + rec.l_seq

    try:
        from margin_tpu_torch.io import native
        if not sync and native.lib() is not None \
                and not bamio.is_cram(bam_in):
            tags = {n: 1 for n in hap1_names if n not in hap2_names}
            tags.update({n: 2 for n in hap2_names if n not in hap1_names})
            tid, start, end = -1, -1, -1
            if region_contig is not None:
                with native.NativeBam(bam_in) as nb:
                    tid = nb.ref_names.index(region_contig)
                start = max(region_start - 1, 0) if region_start > 0 else 0
                end = region_end if region_end > 0 else (1 << 60)
            res = native.write_haplotagged_native(
                bam_in, bam_out, tags, tid, start, end,
                params.polish.includeSecondaryAlignments,
                params.polish.includeSupplementaryAlignments)
            if res is not None:
                return res
    except Exception:
        pass  # fall back to the Python path

    h1 = h2 = h0 = 0
    with bamio.open_alignment(bam_in) as reader:
        with bamio.BamWriter(bam_out, reader.header) as writer:
            if region_contig is not None:
                it = reader.fetch(region_contig, max(region_start - 1, 0),
                                  region_end if region_end > 0 else (1 << 60))
            else:
                it = iter(reader)
            for rec in it:
                if rec.l_seq <= 0 or len(rec.cigar) == 0 or rec.is_unmapped:
                    continue
                if not params.polish.includeSecondaryAlignments and rec.is_secondary:
                    continue
                if not params.polish.includeSupplementaryAlignments and rec.is_supplementary:
                    continue
                if sync:
                    # majority-mapped-length vote per original read name
                    # (htsIntegration.c:1438-1456)
                    l1 = sync_len1.get(rec.name, 0)
                    l2 = sync_len2.get(rec.name, 0)
                    if l1 > l2:
                        hap = 1
                        h1 += 1
                    elif l1 < l2:
                        hap = 2
                        h2 += 1
                    else:
                        hap = 0
                        h0 += 1
                else:
                    name = chunkermod.get_read_name(
                        rec, reader.header.ref_names[rec.ref_id])
                    in1 = name in hap1_names
                    in2 = name in hap2_names
                    if in1 and not in2:
                        hap = 1
                        h1 += 1
                    elif in2 and not in1:
                        hap = 2
                        h2 += 1
                    else:
                        hap = 0
                        h0 += 1
                writer.write_raw(bamio.set_hp_tag(rec.raw, rec, hap))
    return h1, h2, h0
