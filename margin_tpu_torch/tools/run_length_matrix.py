"""runLengthMatrix: tally observed-vs-reference run lengths to train repeat
count substitution matrices.

Copy of `margin_tpu/tools/run_length_matrix.py` with the port's imports.

Parity: tools/runLengthMatrix.c — reads are anchored to the reference via
their CIGARs only (poa_realignOnlyAnchorAlignments), and for every matching
base observation a (strand-resolved base, ref run length, read run length)
count is accumulated; output is four TSV matrices (A/C/G/T)."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from margin_tpu_torch.io import bam as bamio
from margin_tpu_torch.io.fasta import FastaIndex
from margin_tpu_torch.params import Params
from margin_tpu_torch.phase import chunker as chunkermod
from margin_tpu_torch.polish.poa import poa_realign_only_anchor_alignments
from margin_tpu_torch.polish.reads import convert_to_reads_and_alignments
from margin_tpu_torch.rle import RleString

# charToNuclIdx (runLengthMatrix.c:50-67): reverse strand complements
_NUCL_IDX = {("A", True): 0, ("A", False): 3, ("C", True): 1, ("C", False): 2,
             ("G", True): 2, ("G", False): 1, ("T", True): 3, ("T", False): 0}


def main(argv=None):
    p = argparse.ArgumentParser(prog="runLengthMatrix")
    p.add_argument("bam")
    p.add_argument("reference")
    p.add_argument("params")
    p.add_argument("-o", "--outputBase", default="output")
    p.add_argument("-r", "--region", default=None)
    p.add_argument("-l", "--maxRunLength", type=int, default=50)
    p.add_argument("-p", "--depth", type=int, default=-1,
                   help="override the downsampling depth set in PARAMS "
                        "(runLengthMatrix.c:45)")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="compatibility flag (runLengthMatrix.c:40): "
                        "accepted but unused")
    p.add_argument("-a", "--logLevel", default="INFO",
                   help="compatibility flag (runLengthMatrix.c:37)")
    args = p.parse_args(argv)
    # a CRAM decodes against the reference given (the drivers register
    # theirs the same way; margin_tpu's tool registers none)
    bamio.set_cram_reference(args.reference)

    params = Params.load(args.params)
    pp = params.polish
    if args.depth >= 0:
        pp.maxDepth = args.depth
    import random
    rng = random.Random(0)
    if not pp.useRunLengthEncoding:
        p.error("runLengthMatrix requires RLE params")
    max_rl = args.maxRunLength + 1  # exclusive bound like the reference

    chunkr = chunkermod.construct_chunker(args.bam, args.region, None, pp,
                                          record_filtered_reads=False)
    fasta = FastaIndex(args.reference)
    counts = np.zeros((4, max_rl, max_rl), dtype=np.int64)

    reader = bamio.open_alignment(args.bam)
    for chunk in chunkr.chunks:
        raw_ref = fasta.fetch(chunk.ref_name, chunk.chunk_overlap_start,
                              chunk.chunk_overlap_end).upper()
        rle_ref = RleString.encode(raw_ref)
        reads, alignments, _f, _fa = convert_to_reads_and_alignments(
            chunk, rle_ref, reader, pp, keep_filtered=False)
        # downsampleViaReadLikelihood (runLengthMatrix.c:352-359): keep each
        # read with p = maxDepth / avgDepth
        if pp.maxDepth > 0 and reads:
            total_nt = sum(r.rle_read.length for r in reads)
            span = chunk.chunk_overlap_end - chunk.chunk_overlap_start
            avg = total_nt / span
            if avg >= pp.maxDepth:
                ratio = pp.maxDepth / avg
                kept = [(r, a) for r, a in zip(reads, alignments)
                        if rng.random() < ratio]
                reads = [r for r, _ in kept]
                alignments = [a for _, a in kept]
        poa = poa_realign_only_anchor_alignments(reads, alignments, rle_ref, pp)
        for pos in range(1, len(poa.nodes)):
            node = poa.nodes[pos]
            ref_rl = min(node.repeat_count, max_rl - 1)
            for read_no, offset, _w in node.observations:
                r = reads[read_no]
                read_nucl = r.rle_read.bases[offset]
                if read_nucl != node.base:
                    continue
                idx = _NUCL_IDX.get((read_nucl, r.forward_strand))
                if idx is None:
                    continue
                read_rl = min(int(r.rle_read.counts[offset]), max_rl - 1)
                counts[idx, ref_rl, read_rl] += 1
    reader.close()

    for nucl, letter in ((0, "A"), (1, "C"), (2, "G"), (3, "T")):
        path = f"{args.outputBase}.run_lengths.{letter}.tsv"
        with open(path, "w") as fh:
            header = ["#ref_rl"] + [
                f"read_{j}{'+' if j == max_rl - 1 else ''}"
                for j in range(1, max_rl)]
            fh.write("\t".join(header) + "\n")
            for ref_rl in range(1, max_rl):
                row = [str(ref_rl)] + [str(int(counts[nucl, ref_rl, j]))
                                       for j in range(1, max_rl)]
                fh.write("\t".join(row) + "\n")
        print(f"Wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
