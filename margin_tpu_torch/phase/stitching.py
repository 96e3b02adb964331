"""Chunk stitching for phase mode: per-chunk read partitions are merged
across chunk seams with a cis/trans phase vote.

Parity: outputChunkers_processChunkSequencePhased (stitching.c:875-925, the
read-partition records), chunkToStitch_phaseAdjacentChunks
(stitching.c:345-403), addToHapReadsSeen (stitching.c:246-287),
mergeContigChunkz (stitching.c:1413-1499) and
outputChunkers_stitchAndTrackExtraData (stitching.c:1558-1693).

TPU scale-out note: the only inter-chunk state is each chunk's two
(read name -> prob) maps — tiny host-side data. In the multi-host design
these are all-gathered and the vote/merge runs identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class ChunkPhaseResult:
    """The stitch-relevant output of one phased chunk."""
    chunk_idx: int
    ref_name: str
    # read name -> phred prob of correct assignment; filtered reads get -1.0
    hap1_reads: Dict[str, float] = field(default_factory=dict)
    hap2_reads: Dict[str, float] = field(default_factory=dict)
    was_switched: bool = False
    do_not_switch: bool = False


def _intersection_size(acc: Dict[str, float], chunk: Dict[str, float],
                       primary_only: bool) -> int:
    n = 0
    for name, prob in chunk.items():
        if primary_only and prob < 0:
            continue
        p = acc.get(name)
        if p is None:
            continue
        if primary_only and p < 0:
            continue
        n += 1
    return n


def _add_reads_seen(hap: Dict[str, float], other: Dict[str, float],
                    to_add: Dict[str, float]):
    """addToHapReadsSeen (stitching.c:246-287): prob-based dedup across
    haplotypes and chunks."""
    for name, prob in to_add.items():
        p_other = other.get(name)
        if p_other is not None:
            if prob > p_other:
                del other[name]
            else:
                continue
        p_here = hap.get(name)
        if p_here is None or prob > p_here:
            hap[name] = prob


def stitch_phase_results(results: List[ChunkPhaseResult],
                         primary_only: bool = False
                         ) -> Tuple[List[str], List[str], List[bool]]:
    """Returns (read_ids_hap1, read_ids_hap2, chunk_was_switched) across all
    chunks (ordered by chunk_idx, grouped by contig)."""
    results = sorted(results, key=lambda r: r.chunk_idx)
    switched = [False] * (max((r.chunk_idx for r in results), default=-1) + 1)
    ids1: List[str] = []
    ids2: List[str] = []
    # group consecutive chunks by contig (stitching.c:1613-1630)
    i = 0
    while i < len(results):
        j = i
        while j < len(results) and results[j].ref_name == results[i].ref_name:
            j += 1
        contig = results[i:j]
        acc1 = dict(contig[0].hap1_reads)
        acc2 = dict(contig[0].hap2_reads)
        for r in contig[1:]:
            stitch_next_chunk(acc1, acc2, r, primary_only=primary_only)
            switched[r.chunk_idx] = r.was_switched
        ids1.extend(acc1.keys())
        ids2.extend(acc2.keys())
        i = j
    return ids1, ids2, switched


def stitch_next_chunk(acc1: Dict[str, float], acc2: Dict[str, float],
                      r: ChunkPhaseResult, primary_only: bool):
    """chunkToStitch_phaseAdjacentChunks (stitching.c:345-403) + merge."""
    h1, h2 = r.hap1_reads, r.hap2_reads
    cis = (_intersection_size(acc1, h1, primary_only)
           + _intersection_size(acc2, h2, primary_only))
    trans = (_intersection_size(acc2, h1, primary_only)
             + _intersection_size(acc1, h2, primary_only))
    if cis < trans and not r.do_not_switch:
        h1, h2 = h2, h1
        r.was_switched = True
    _add_reads_seen(acc1, acc2, h1)
    _add_reads_seen(acc2, acc1, h2)
