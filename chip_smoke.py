#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (margin_tpu_torch) of `margin phase`,
haploid and diploid `margin polish` with HELEN features, Baum-Welch EM and
the aux tools, from BAM and from CRAM and BCF inputs, and the
read-partition HMM's device forward-backward, on one NVIDIA GPU and check
it end to end.

    python3 chip_smoke.py [--only kernels,phase,polish,diploid,em,helen,
                           tools,cram,rphmm,k1,k5,k6]

(--only runs a subset after the build, for iterating on one path; k1 runs
K1's shapes of phase 2 alone, about a minute with the build; k5 holds
both K5 designs against the twins and times them on packs of band widths
136-1064, RLE off and on, and on two pairs of ~7950 diagonals at W = 208
(anchored every 6 bases, and on its kmers as the em phase's pairs), both
logAdds, about 2.5 minutes with the build; k6 runs K6 on a cross
product of work >= 10M, sites of 300 and 800 alleles, merge rows of
20,000 slots and a seeded merge tree, each held and timed; tools and rphmm need
phase, cram needs phase and polish; a plain run takes all but k1, k5 and
k6 and is the one that prints the kernels line.)

Phases (any failure raises and the script exits non-zero):
  1. print the card (nvidia-smi name, power limit) and whether h5py is
     installed; build the CUDA kernels and the host C++ engines from the
     checkout's sources, in parallel; fail unless every host engine loads
     (marginio against the system's libdeflate or the port's zlib
     stand-in, printed);
  2. hold every kernel against its plain PyTorch twin on the card: K1 on
     131072 pairs of 29x32, on ragged batches with lx, ly in 1..1024 (RLE
     on and off), on 630 pairs like the phase run's largest batch (one
     909x916 pair, 629 of 60..200, padded to 909x916) and on 16 deep pairs
     (ly 4000..8191, padded to 8191, RLE on), both logAdds, each line with
     the deepest pair's diagonal count and ns per diagonal; K2 on packs of
     128 problems with lx, ly ~ 500-1200 at band widths 16, 32, 64 and 128
     (one block shape per width), each with RLE on and off, LUT
     everywhere and the exact logAdd at two of them, each width at its
     launch's chunk depth K2_CHUNK, and timed on packs of lx, ly ~
     2000-5000. LUT logAdd: identical bits; exact logAdd: max |diff| <=
     1e-4; on every pack K2-bwd's WORDS instance against K2-bwd POST's
     grid through extract_packed (identical words as sorted keys);
  3. run `python -m margin_tpu_torch phase` (its `cli.main`, LUT logAdd)
     on a seeded synthetic 1 Mb contig at 30x (5-30 kb reads, ~8% errors,
     ~1000 het SNVs, 30 het SVs of 50-2000 bp); the launch counters are
     zeroed right before and read right after. Checks: K1, K2-fwd and
     K2-bwd's WORDS instance launched and extract_packed never called,
     >= half the true het sites phased, haplotags agree with the simulated
     origin on >= 90% of tagged reads; then the same run again under
     torch.profiler (CPU and CUDA activities): the device's busy share of
     the run, device time by kernel, and the host and device time of
     K2-bwd WORDS's wrapper (scripts/phase_trace.py traces one checkout
     the same way, to set two commits side by side);
  4. rerun a 200 kb sub-region with the kernels and (at the end) with the
     plain twins bound in their place: byte-identical phased VCF and
     phaseset.bed;
  2b. hold the segmented kernels K3-fwd / K3-bwd against K2 on packs of 64
     problems with lx, ly ~ 2000-5000 (identical words and totals) and
     against their twins on packs of lx, ly ~ 500-1200 (LUT: identical
     words and totals; exact: totals within 1e-4, identical pair sets), at
     widths 16, 32, 64 and 128, RLE on and off, both logAdds, each width
     at its launch's segment depth SEG_D[w];
     then time K3 alone on a deep pack (128 problems, lx, ly ~ 30k-70k,
     W = 32, SEG_D[32]);
  5. hold each kernel against its twin, and time both, on the largest
     batch / pack the phase run gave it (for K2: W=128, RLE off, LUT,
     with its deepest diagonal count and ns per diagonal); K4, K2-bwd
     WORDS (held against extract_packed on K2-bwd POST's grid and against
     its twin) and the torch-op extraction it replaced are timed on K2's
     pack beside it;
  6. run `python -m margin_tpu_torch polish` (cli.main, LUT logAdd) on a
     seeded synthetic 120 kb draft at 30x (5-30 kb reads, ~8% errors,
     100 kb chunks with 1 kb boundaries: two chunks, one stitch seam;
     cut from 300 kb, then to 205, 150 and 120 kb, to keep the whole run
     within its time limit); launch counters zeroed right before, read right after.
     Checks: K1, K2 (K2-bwd as its WORDS instance) and K3 launched,
     extract_packed never called, items on the segmented route, and the
     polished contig's edit distance to the truth at most half the
     draft's; K2-bwd WORDS held against extract_packed on the run's
     largest K2 pack (also for phase 8's run) and timed there beside
     K2-bwd POST and the torch-op extraction;
  7. polish a 5 kb sub-region in process (run_polish, the dataset's
     own POA-consensus iterations and bubble pass, channelRleWeight HELEN
     features labelled by the set's truth.bam) with SEG_MIN_D lowered to
     2048, through the kernels and (at the end) through the plain twins
     bound in their place: byte-identical FASTA and feature arrays and
     labels; then time K3 on the largest K3 pack of phase 6 and hold it
     against K2 there (identical words and totals), and against its twin
     on that pack's 16 shallowest problems (the twin walks one diagonal
     at a time, so its time follows the deepest problem it is given);
     K2-fwd / K2-bwd are timed on the same pack beside it, and K2 / K3 per
     sweep is printed (a ratio that compares across cards where a time
     does not);
  8. run `python -m margin_tpu_torch polish --diploid` (cli.main, LUT
     logAdd) on a seeded synthetic diploid 120 kb draft at 30x (two
     haplotypes with a het SNV or 1-10 bp het indel every 1-1.5 kb, the
     draft made from haplotype 1 with phase 6's draft edits, 5-30 kb reads
     from both, 100 kb chunks with 1 kb boundaries: two chunks, one
     phased seam; cut from 205 and 150 kb to keep the whole run within
     its time limit); launch counters zeroed right before, read right after.
     Checks: K1, K2 and K3 launched, haplotag agreement with the reads'
     true haplotypes >= 90% (up to a swap: the stitched contig is one
     phase set); logs each haplotype FASTA's edit distance to each truth
     haplotype and the draft's, the stages and the device ms;
  9. diploid-polish a 5 kb sub-region in process with SEG_MIN_D lowered
     to 2048 and the truth haplotypes riding along (-u truth.bam; they
     must land on different haplotypes), through the kernels and (at the
     end) through the plain twins bound in their place: identical hap
     FASTAs, haplotagged BAM records and truth-haplotype partition;
 10. em: Baum-Welch through the port's entry points, counters zeroed
     right before and read right after each pass: 1024 read-to-draft
     pairs of 1-4 kb cut from phase 6's set through
     HmmExpectations.add_expectations on kmer anchors, as margin's EM
     anchors them (bands of 100-400 cells: K5-fwd, then K5-exp, on every
     band wider than 128 cells, K2-fwd and K4 on the rest; K5's launches
     counted by design, all on K2's step up to 512 cells), then the same
     pairs anchored on their alignments (K2-fwd, then K4), then
     em_iteration over 256 pairs of 60-120 bases, LUT and exact; both K5
     designs held against the twins on the widest and the deepest
     kmer-anchored pair (forward grid and totals identical under the
     LUT, expectations within K4's tolerance, the strided design's
     device-memory ring identical to its shared one) and timed on each;
     K4 held against its twin (rtol
     1e-5, atol 1e-7 x the matrix sum; K2-fwd's totals identical under
     the LUT) at the shapes the path launches it on: the 16 shallowest
     read pairs as one pack, the 2 deepest each alone as add_expectations
     launches them (timed on the deepest), and every pack em_iteration
     launched;
 11. helen: splitRleWeight labelled by truth.bam on the first 51 kb of
     phase 6's set (one chunk; cut from its 101 kb production chunk to
     keep the whole run within its time limit), counters zeroed right
     before and read right after (the truth alignment, ~76k diagonals,
     takes K3; at least a feature row a base; the consensus rows' labels
     must be nucleotides);
     simpleWeight (run-length encoding off) labelled on a 5 kb
     region through the kernels and (at the end) the twins: identical
     arrays and labels. The feature groups are held in memory, as the
     HDF5 file would get them (h5py is not on every card machine);
 12. tools: tagFromPhasedVcf on phase 3's phased VCF over phase 4's
     region through the kernels (K1, counters zeroed right before and
     read right after) and (at the end) the twins: identical haplotagged
     BAM records; runLengthMatrix, tagFromIds and
     calcLocalPhasingCorrectness once each (host only);
 13. cram: phase 4's region of phase 3's BAM written as a CRAM (the
     port's CramWriter, 64 records a slice) and phase 3's VCF as a BCF
     (vcf_to_bcf), then `python -m margin_tpu_torch phase` on them over
     that region (cli.main, counters zeroed right before and read right
     after): K1 and K2 launched, phaseset.bed byte-identical to phase 4's
     BAM + VCF kernel run, the phased VCF too but for the INFO column
     vcf_to_bcf does not encode, the haplotagged BAM's records identical;
     then phase 7's region polished from a CRAM of its reads: FASTA and
     HELEN arrays identical to phase 7's BAM run; CRAM write and decode
     seconds logged;
 14. rphmm: the read-partition HMM's FB on K6. margin_tpu's path without
     the native engine, through the entry points with
     MARGIN_TPU_RPHMM=device on the profile sequences of phase 4's
     region chunk with the most reads (get_rp_hmms ->
     merge_two_tiling_paths -> fuse_tiling_path -> forward_backward; the
     K6 counter zeroed right before and read right after), three turns
     each way: the same traceback and genome fragment as with
     MARGIN_TPU_RPHMM=host, K6 held against its twin and timed on the
     largest FB of that run; every fused HMM the native engine returned
     for phase 4's chunks FB'd again through K6, its twin and the host
     float64 path (identical fields; timed on the one of most work); a
     cross product of two seeded random read sets' tiling paths of work
     >= 10M, which MARGIN_TPU_RPHMM=auto sends to K6 by itself, held and
     timed the same way (the pack's ms beside it); and K6 against its
     twin on seeded packs with a site of 300 alleles and one of 800 and
     the ancestor (allele sums in shared memory, then in device memory)
     and on one of 20,000 merge slots (the carry in device memory). Each
     K6 time has k6_emissions and k6_chain apart (torch.profiler) and the
     chain's ns a column; each FB of the merge tree its pack's ms;
 15. the queued twin runs (phases 4, 7, 9, 11, 12), all at once, each in
     a subprocess of its own sharing the card, then each comparison
     (the polish, diploid and HELEN regions are TWIN_REGION_LEN = 5 kb,
     cut from 10 kb to keep the whole run within its time limit: the
     twins walk one diagonal at a time).
Each phase's seconds are logged as it ends ("... phase NAME: S s") and
kept under "phase_s" in chiprun_out/chip_smoke.json.
Every K1, K2, K3 and K4 timing also prints the deepest pair's or
problem's diagonal count and the nanoseconds per diagonal; the device
time each kernel and the extraction summed over the phase and polish
runs' launches is printed at the end (the diploid run's on its own line
in phase 8). Phases 3, 6 and 8
log their K1 launches by padded Ly and write each launch's shape and
pair lengths to chiprun_out/k1_launches.json, which
scripts/k1_replay.py replays to time one checkout's K1 on them.
The line before last is {"kernels": [...]} (times from this run, bounds
from this run's inputs), the one before it the card, and the last line
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores and
# HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float ops per band cell. logAdd, LUT: max, min, sub, 4 compares, cubic
# (3 mul + 3 add), add, select = 15; exact: max, sub, abs, exp, log1p,
# add = 6. Forward cell: 3 states x (3 transition adds + 2 logAdds +
# emission add + clamp). Backward cell: 3 states x (6 adds + 2 logAdds +
# clamp) + 3 posteriors x (add, sub, min, exp).
_LOGADD = {True: 15, False: 6}


def fwd_ops_per_cell(lut):
    return 3 * (5 + 2 * _LOGADD[lut])


def bwd_ops_per_cell(lut):
    return 3 * (7 + 2 * _LOGADD[lut]) + 12


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=5, warmup=1):
    """Median CUDA-event time of fn() in ms, after warm-up runs."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound_ms(ops, nbytes):
    t_ops = ops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def compare(name, got, want, lut):
    """LUT: identical bits; exact: max |diff| <= 1e-4."""
    import torch
    if lut:
        if not torch.equal(got, want):
            diff = (got - want).abs().max().item()
            raise AssertionError(f"{name}: LUT results differ (max {diff})")
        return 0.0
    diff = (got - want).abs().max().item()
    if not diff <= 1e-4:
        raise AssertionError(f"{name}: exact results differ by {diff} > 1e-4")
    return diff


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def tables(device, rle):
    import numpy as np
    from margin_tpu_torch.ops import pairhmm
    from margin_tpu_torch.params import RepeatSubMatrix, StateMachineParams
    rep = None
    if rle:
        rep = RepeatSubMatrix.empty()
        rep.log_probs = np.random.default_rng(11).uniform(-4.0, -0.05,
                                                          (4, 51, 51))
    return pairhmm.PairHmmTables.from_params(
        StateMachineParams.default_nucleotide(), repeat=rep, device=device)


def k1_batch(device, B, lx_range, ly_range, seed, rle=False, first=None,
             pad_to=None):
    """B seeded pairs with lx, ly uniform in their ranges; first: (lx, ly)
    of pair 0 instead; pad_to: the batch's least (Lx, Ly)."""
    import numpy as np
    from margin_tpu_torch.ops import pairhmm
    rng = np.random.default_rng(seed)
    lxs = rng.integers(lx_range[0], lx_range[1] + 1, B)
    lys = rng.integers(ly_range[0], ly_range[1] + 1, B)
    if first is not None:
        lxs[0], lys[0] = first
    pairs = [(rng.integers(0, 4, a).astype(np.uint8),
              rng.integers(0, 4, b).astype(np.uint8))
             for a, b in zip(lxs, lys)]
    reps = ([(rng.integers(1, 12, a), rng.integers(1, 12, b))
             for a, b in zip(lxs, lys)] if rle else None)
    return pairhmm.make_batch(pairs, strands=rng.integers(0, 2, B),
                              ragged_left=rng.random(B) < 0.1,
                              ragged_right=rng.random(B) < 0.1,
                              rep_pairs=reps, device=device, pad_to=pad_to)


def k2_items(n, w_bucket, expansion, seed, rle, lx_range=(2000, 5000)):
    """n problems with lx in lx_range: y an erroneous copy of x, anchored
    every few bases along the true alignment so every band falls in the
    width bucket w_bucket (16 with expansion 4; 32, 64 or 128 with
    expansion 20)."""
    import numpy as np
    from margin_tpu_torch.ops import banded
    rng = np.random.default_rng(seed)
    spacing = {16: 6, 32: 8, 64: 24, 128: 64}[w_bucket]
    lo = {16: 0, 32: 16, 64: 32, 128: 64}[w_bucket]
    items = []
    while len(items) < n:
        lx = int(rng.integers(lx_range[0], lx_range[1] + 1))
        x = rng.integers(0, 4, lx).astype(np.uint8)
        y = x.copy()
        flip = rng.random(lx) < 0.06
        y[flip] = (y[flip] + rng.integers(1, 4, int(flip.sum()))) % 4
        keep = rng.random(lx) > 0.03
        ypos = np.cumsum(keep) - 1
        y = y[keep]
        xa = np.nonzero(keep)[0][::spacing][1:-1]
        it = {"x_sym": x, "y_sym": y, "strand": int(rng.integers(0, 2)),
              "anchors": [(int(a), int(ypos[a]), expansion) for a in xa]}
        if rle:
            it["rep_x"] = rng.integers(1, 12, lx).astype(np.int32)
            it["rep_y"] = rng.integers(1, 12, len(y)).astype(np.int32)
        w = banded._item_geom(it, expansion, False).w_pad
        if lo < w <= w_bucket:
            items.append(it)
    return items


def k2_pack(device, tabs, items, w_bucket, expansion, rle):
    from margin_tpu_torch.ops import banded, cuda_banded
    geoms = [banded._item_geom(it, expansion, False) for it in items]
    return cuda_banded._pack_host(tabs, items, w_bucket, expansion, False,
                                  rle, geoms, device=device)


# ---------------------------------------------------------------------------
# bytes and operations of each kernel's work on its inputs
# ---------------------------------------------------------------------------

def k1_diagonals(batch):
    """The deepest pair's diagonal steps, max(lx + ly): a K1 launch lasts
    as long as that chain."""
    return int((batch.lxs.long() + batch.lys.long()).max())


def k1_work(batch, tabs, lut):
    lx = batch.lxs.long()
    ly = batch.lys.long()
    cells = int(((lx + 1) * (ly + 1) - 1).clamp(min=0).sum())
    nbytes = (batch.xs.numel() + batch.ys.numel() + 4 * 3 * batch.lxs.numel()
              + 2 * batch.lxs.numel() + 4 * batch.lxs.numel())
    if batch.rep_x is not None and tabs.repeat is not None:
        nbytes += 4 * (batch.rep_x.numel() + batch.rep_y.numel())
        nbytes += tabs.repeat.numel() * 4
    return cells * fwd_ops_per_cell(lut), nbytes


def pack_input_bytes(pack):
    """Bytes of a pack's inputs, each read once: symbols (and run lengths)
    of every sequence, the per-diagonal geometry, the per-problem scalars
    and tables."""
    n_sym = sum(g.lx + g.ly for g in pack.geoms)
    nbytes = (n_sym + 12 * pack.n_rows
              + pack.B * (4 * (35 + 9 + 6) + 4 * 5 + 8 * 3))
    if pack.rep_x is not None:
        nbytes += 4 * n_sym + pack.rep_tab.numel() * 4
    return nbytes


def k2_work(pack, lut, sweep):
    from margin_tpu_torch.ops import banded
    cells = sum(banded._true_band_cells(g) for g in pack.geoms)
    grid = pack.n_rows * 3 * pack.W * 4
    nbytes = pack_input_bytes(pack)
    if sweep == "fwd":
        return cells * fwd_ops_per_cell(lut), nbytes + grid + 4 * pack.B
    return cells * bwd_ops_per_cell(lut), nbytes + 2 * grid + 4 * pack.B


def k3_work(pack, lut, sweep, seg_d, n_words=0):
    """The segmented sweeps' work on their inputs: the forward's cell
    operations and its checkpoints and totals written (K3-fwd); the
    backward's cell operations, the checkpoints read and the words written
    (K3-bwd). The recompute is the design's cost, not work."""
    from margin_tpu_torch.ops import banded, cuda_banded
    cells = sum(banded._true_band_cells(g) for g in pack.geoms)
    nbytes = pack_input_bytes(pack)
    ckpt = cuda_banded.seg_layout(pack, seg_d)[1] * 2 * 3 * pack.W * 4
    if sweep == "fwd":
        return cells * fwd_ops_per_cell(lut), nbytes + ckpt + 4 * pack.B
    return (cells * bwd_ops_per_cell(lut),
            nbytes + ckpt + 4 * pack.B + 8 * n_words)


def word_set(totals, lo, hi):
    """(totals as host float32, the words as sorted int64 keys hi << 32 |
    lo on the device) of one pack's extraction: word order is free."""
    import torch
    key = (hi.long() << 32) | (lo.long() & 0xFFFFFFFF)
    return totals.cpu().numpy(), torch.sort(key).values


def compare_words(name, got, want, lut):
    """LUT: identical totals and words; exact: totals within 1e-4 and
    identical pair sets (problem, state, diagonal, k). Returns max
    |diff| of the totals."""
    import torch
    (tg, kg), (tw, kw) = got, want
    diff = float(abs(tg - tw).max()) if len(tg) else 0.0
    if lut:
        if not (diff == 0.0 and (tg == tw).all() and torch.equal(kg, kw)):
            raise AssertionError(f"{name}: LUT results differ (totals "
                                 f"{diff}, words {kg.numel()} vs "
                                 f"{kw.numel()})")
        return 0.0
    # key >> 24 = (hi << 8) | k, in the keys' order
    if not (diff <= 1e-4 and torch.equal(kg >> 24, kw >> 24)):
        raise AssertionError(f"{name}: exact results differ (totals "
                             f"{diff})")
    return diff


def extracted_words(post, totals, pack, threshold):
    """word_set of banded.extract_packed (the torch-op extraction) on a
    posterior grid."""
    import torch
    from margin_tpu_torch.ops import banded
    packed = banded.extract_packed(post, totals, pack, threshold)
    n, c = pack.B, int(packed[0])
    return word_set(packed[1:1 + n].view(torch.float32),
                    packed[1 + n:1 + n + c], packed[1 + n + c:])


def k2_words(pack, lut, threshold=0.01):
    """The monolithic kernels' extraction words of a pack, whatever the
    size of its grids (the card holds 80 GB; the routing budget
    FB_GRID_BUDGET_BYTES is lifted for this comparison only): K2-bwd
    POST's grid through extract_packed."""
    from margin_tpu_torch.ops import cuda_banded
    budget = cuda_banded.FB_GRID_BUDGET_BYTES
    cuda_banded.FB_GRID_BUDGET_BYTES = max(
        budget, cuda_banded.grid_bytes(pack.n_rows, pack.W))
    try:
        fk, tk = cuda_banded.fb_forward(pack, lut)
    finally:
        cuda_banded.FB_GRID_BUDGET_BYTES = budget
    pk = cuda_banded.fb_backward(pack, fk, tk, lut)
    del fk
    return extracted_words(pk, tk, pack, threshold)


def words_work(pack, lut, n_words):
    """K2-bwd WORDS on a pack: the backward's cell operations; the inputs,
    the forward grid and the totals read once, the count and the words
    written once."""
    from margin_tpu_torch.ops import banded
    cells = sum(banded._true_band_cells(g) for g in pack.geoms)
    return (cells * bwd_ops_per_cell(lut),
            pack_input_bytes(pack) + pack.n_rows * 3 * pack.W * 4
            + 4 * pack.B + 4 + 8 * n_words)


def words_against(pack, fk, tk, pk, lut, threshold, label):
    """K2-bwd WORDS on a pack against K2-bwd POST's grid pk through
    extract_packed (the same cells on the card: identical words as sorted
    keys, whatever the logAdd). Returns (lo, hi)."""
    from margin_tpu_torch.ops import cuda_banded
    lo, hi = cuda_banded.fb_backward_words(pack, fk, tk, lut, threshold)
    compare_words(f"K2-bwd WORDS against extract_packed, {label}",
                  word_set(tk, lo, hi),
                  extracted_words(pk, tk, pack, threshold), True)
    return lo, hi


def k3_run(pack, lut, seg_d, threshold=0.01):
    """K3-fwd then K3-bwd on a pack: (ckpt, totals, lo, hi)."""
    from margin_tpu_torch.ops import cuda_banded
    ck, tk = cuda_banded.seg_forward(pack, lut, seg_d)
    lo, hi = cuda_banded.seg_backward(pack, ck, tk, lut, seg_d, threshold)
    if not bool(tk.isfinite().all()):
        raise AssertionError("K3: non-finite totals")
    return ck, tk, lo, hi


def deepest(pack):
    """The pack's deepest diagonal count, max(lx + ly + 1)."""
    return max(g.lx + g.ly + 1 for g in pack.geoms)


def k3_times(pack, lut, seg_d, threshold, n_words, reps=3):
    """Median CUDA-event times (ms) of K3-fwd and K3-bwd on a pack."""
    from margin_tpu_torch.ops import cuda_banded
    ck, tk = cuda_banded.seg_forward(pack, lut, seg_d)
    f_ms = cuda_ms(lambda: cuda_banded.seg_forward(pack, lut, seg_d),
                   reps=reps)
    b_ms = cuda_ms(lambda: cuda_banded.seg_backward(
        pack, ck, tk, lut, seg_d, threshold, cap=n_words + 1), reps=reps)
    return f_ms, b_ms


def k3_against(pack, lut, seg_d, label, threshold=0.01, twin=True):
    """K3 against K2 and (twin=True) against its twin on one pack, with
    the times of both sweeps; returns the rows for K3-fwd and K3-bwd."""
    from margin_tpu_torch.ops import cuda_banded
    ck, tk, lo, hi = k3_run(pack, lut, seg_d, threshold)
    got = word_set(tk, lo, hi)
    compare_words(f"K3 vs K2 {label}", got, k2_words(pack, lut, threshold),
                  True)
    diff, pf_ms, pb_ms = None, None, None
    if twin:
        t0 = time.perf_counter()
        cp, tp = cuda_banded.seg_forward_plain(pack, lut, seg_d)
        torch_sync()
        pf_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        lp, hp = cuda_banded.seg_backward_plain(pack, cp, tp, lut, seg_d,
                                                threshold)
        torch_sync()
        pb_ms = (time.perf_counter() - t0) * 1e3
        diff = compare_words(f"K3 {label}", got, word_set(tp, lp, hp), lut)
    f_ms, b_ms = k3_times(pack, lut, seg_d, threshold, lo.numel())
    d_max = deepest(pack)
    rows = []
    for name, ms, pms, sweep in (("K3-fwd", f_ms, pf_ms, "fwd"),
                                 ("K3-bwd", b_ms, pb_ms, "bwd")):
        bms, by = bound_ms(*k3_work(pack, lut, sweep, seg_d, lo.numel()))
        rows.append({"kernel": name, "shape": label, "lut": lut,
                     "rows": pack.n_rows, "words": lo.numel(),
                     "deepest_diagonals": d_max,
                     "ns_per_diagonal": ms * 1e6 / d_max,
                     "max_abs_err": diff, "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by})
        plain = "" if pms is None else f", plain {pms:.0f} ms"
        log(f"{name} {label} {'LUT' if lut else 'exact'}: kernel {ms:.2f} "
            f"ms{plain}, bound {bms:.4f} ms ({by}); deepest {d_max} "
            f"diagonals, {ms * 1e6 / d_max:.1f} ns per diagonal; words "
            "equal K2's"
            + ("" if diff is None else f" and the twin's (max|diff| {diff})"))
    return rows


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def card_line():
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return res.stdout.strip().splitlines()[0] if res.stdout else \
            "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def phase_build():
    from margin_tpu_torch import _ext
    t0 = time.perf_counter()
    names = list(_ext.KERNEL_SOURCES) + list(_ext.NATIVE_ENGINES)
    errors = _ext.build(names, log=log)
    for k in _ext.KERNEL_SOURCES:
        if errors[k] is not None:
            raise RuntimeError(f"kernel {k} failed to build:\n{errors[k]}")
        _ext.kernel_lib(k)
    engines = {n: _ext.native_lib(n) is not None
               for n in _ext.NATIVE_ENGINES}
    deflate = _ext.deflate_variant()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.1f} s; host engines loaded: {engines}; marginio "
        f"built against {deflate}")
    # the port keeps pure-Python paths for a missing engine, but the
    # measured path runs the engines the CPU tests hold against margin_tpu
    missing = [n for n, ok in engines.items() if not ok]
    if missing:
        for n in missing:
            tail = [ln for ln in (errors.get(n) or "").splitlines()
                    if ln.strip()][-3:]
            log(f"host engine {n} did not load: {' | '.join(tail)} "
                f"{_ext.LOAD_ERRORS.get(n, '')}")
        raise RuntimeError(f"host engines not loaded: {missing}")
    return {"build_s": secs, "engines": engines, "deflate": deflate,
            "per_source_s": dict(_ext.BUILD_SECONDS)}


# K1's shapes of phase 2: (label, B, lx range, ly range, RLE, seed,
# (lx, ly) of pair 0, padded to)
K1_SHAPES = [
    ("131072 x 29x32", 131072, (29, 29), (32, 32), False, 100, None, None),
    ("2048 ragged 1..1024", 2048, (1, 1024), (1, 1024), False, 101, None,
     None),
    ("2048 ragged 1..1024, RLE", 2048, (1, 1024), (1, 1024), True, 102,
     None, None),
    ("630 like the main path, 909x916 + 60..200", 630, (60, 200),
     (60, 200), False, 103, (909, 916), (909, 916)),
    ("16 deep, lx 200..400, ly 4000..8191, RLE", 16, (200, 400),
     (4000, 8191), True, 104, None, (400, 8191))]


def phase_k1(device):
    """K1 against its twin, both logAdds, with the time of each: the
    bubble-scoring shape (131072 x 29x32), ragged batches, a batch like
    the phase run's largest (one 909x916 pair among 629 of 60-200, padded
    to 909x916) and a deep batch (ly 4000-8191, padded to 8191: R = 8)."""
    import torch
    from margin_tpu_torch.ops import pairhmm
    rows = []
    for label, B, lxr, lyr, rle, seed, first, pad_to in K1_SHAPES:
        tabs = tables(device, rle)
        batch = k1_batch(device, B, lxr, lyr, seed=seed, rle=rle,
                         first=first, pad_to=pad_to)
        d_max = k1_diagonals(batch)
        for lut in (True, False):
            got = pairhmm.forward_total(tabs, batch, use_lut=lut)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            want = pairhmm.forward_total_plain(tabs, batch, use_lut=lut)
            e.record()
            torch_sync()
            pms = s.elapsed_time(e)
            diff = compare(f"K1 {label}", got, want, lut)
            if not bool(got.isfinite().all()):
                raise AssertionError(f"K1 {label}: non-finite totals")
            ms = cuda_ms(lambda: pairhmm.forward_total(tabs, batch, lut))
            ops, nbytes = k1_work(batch, tabs, lut)
            bms, by = bound_ms(ops, nbytes)
            rows.append({"kernel": "K1", "shape": label, "lut": lut,
                         "Lx": batch.xs.shape[1], "Ly": batch.ys.shape[1],
                         "deepest_diagonals": d_max,
                         "ns_per_diagonal": ms * 1e6 / d_max,
                         "max_abs_err": diff, "ms": ms, "plain_ms": pms,
                         "bound_ms": bms, "bound_by": by})
            log(f"K1 {label} {'LUT' if lut else 'exact'}: kernel {ms:.3f} ms"
                f", plain {pms:.1f} ms, bound {bms:.4f} ms ({by}); deepest "
                f"{d_max} diagonals, {ms * 1e6 / d_max:.1f} ns per diagonal;"
                f" max|diff| {diff}")
    return rows


def phase_k2(device, n=128):
    """K2 timed on packs of lx, ly 2000-5000 and held against its twins on
    packs of lx, ly 500-1200 (the twins walk ~1 ms per diagonal), at every
    width and RLE state, each width at its launch's chunk depth."""
    from margin_tpu_torch.ops import cuda_banded
    rows = []
    # (width, RLE, logAdds): LUT everywhere, the exact logAdd at two
    configs = [(16, True, (True,)), (16, False, (True,)),
               (32, False, (True,)), (32, True, (True, False)),
               (64, True, (True,)), (64, False, (True,)),
               (128, True, (True,)), (128, False, (True, False))]
    for ci, (w, rle, luts) in enumerate(configs):
        tabs = tables(device, rle)
        exp = 4 if w == 16 else 20
        for lx_range, twin in (((2000, 5000), False), ((500, 1200), True)):
            items = k2_items(n, w, exp, seed=200 + 10 * ci + twin, rle=rle,
                             lx_range=lx_range)
            pack = k2_pack(device, tabs, items, w, exp, rle)
            label = (f"{n} x lx,ly {lx_range[0]}-{lx_range[1]}, W={w}, RLE "
                     f"{'on' if rle else 'off'}, C="
                     f"{cuda_banded.K2_CHUNK[(w, rle)]}")
            d_max = deepest(pack)
            for lut in luts:
                fk, tk = cuda_banded.fb_forward(pack, lut)
                pk = cuda_banded.fb_backward(pack, fk, tk, lut)
                if not bool(tk.isfinite().all()):
                    raise AssertionError(f"K2 {label}: non-finite totals")
                diffs = {"fwd": None, "bwd": None}
                plain = {"fwd": None, "bwd": None}
                if twin:
                    t0 = time.perf_counter()
                    fp, tp = cuda_banded.fb_forward_plain(pack, lut)
                    torch_sync()
                    plain["fwd"] = (time.perf_counter() - t0) * 1e3
                    t0 = time.perf_counter()
                    pp = cuda_banded.fb_backward_plain(pack, fp, tp, lut)
                    torch_sync()
                    plain["bwd"] = (time.perf_counter() - t0) * 1e3
                    diffs["fwd"] = max(
                        compare(f"K2 totals {label}", tk, tp, lut),
                        compare(f"K2-fwd grid {label}", fk, fp, lut))
                    diffs["bwd"] = compare(f"K2-bwd posteriors {label}", pk,
                                           pp, lut)
                    del fp, pp
                words_against(pack, fk, tk, pk, lut, 0.01, label)
                f_ms = cuda_ms(lambda: cuda_banded.fb_forward(pack, lut),
                               reps=5)
                b_ms = cuda_ms(lambda: cuda_banded.fb_backward(pack, fk, tk,
                                                               lut), reps=5)
                for name, ms, sweep in (("K2-fwd", f_ms, "fwd"),
                                        ("K2-bwd", b_ms, "bwd")):
                    bms, by = bound_ms(*k2_work(pack, lut, sweep))
                    rows.append({"kernel": name, "shape": label, "lut": lut,
                                 "rows": pack.n_rows,
                                 "deepest_diagonals": d_max,
                                 "ns_per_diagonal": ms * 1e6 / d_max,
                                 "max_abs_err": diffs[sweep], "ms": ms,
                                 "plain_ms": plain[sweep], "bound_ms": bms,
                                 "bound_by": by})
                    pms = "" if plain[sweep] is None else \
                        f", plain {plain[sweep]:.0f} ms"
                    log(f"{name} {label} {'LUT' if lut else 'exact'}: kernel "
                        f"{ms:.2f} ms{pms}, bound {bms:.4f} ms ({by}); "
                        f"deepest {d_max} diagonals, "
                        f"{ms * 1e6 / d_max:.1f} ns per diagonal"
                        + ("" if diffs[sweep] is None
                           else f", max|diff| {diffs[sweep]}"))
                del fk, pk
    return rows


def phase_k3(device, n=64):
    """K3 against K2 on packs of lx, ly 2000-5000; K3 against its twin on
    packs of lx, ly 500-1200 (the twin walks ~0.6 ms per diagonal on the
    card, so the full shapes would take minutes); each width at its
    launch's segment depth SEG_D[w]."""
    from margin_tpu_torch.ops import cuda_banded
    rows = []
    configs = [(32, False, True), (32, True, False), (64, True, True),
               (128, True, True), (128, False, False), (16, True, True)]
    for ci, (w, rle, lut) in enumerate(configs):
        tabs = tables(device, rle)
        seg_d = cuda_banded.SEG_D[w]
        exp = 4 if w == 16 else 20
        for lx_range, twin in (((2000, 5000), False), ((500, 1200), True)):
            items = k2_items(n, w, exp, seed=300 + 10 * ci + twin, rle=rle,
                             lx_range=lx_range)
            pack = k2_pack(device, tabs, items, w, exp, rle)
            label = (f"{n} x lx,ly {lx_range[0]}-{lx_range[1]}, W={w}, RLE "
                     f"{'on' if rle else 'off'}, S={seg_d}")
            rows += k3_against(pack, lut, seg_d, label, twin=twin)
    return rows


def phase_k3_deep(device, n=128):
    """K3 alone on a pack of production-depth problems."""
    from margin_tpu_torch.ops import cuda_banded
    t0 = time.perf_counter()
    items = k2_items(n, 32, 20, seed=400, rle=False,
                     lx_range=(30_000, 70_000))
    pack = k2_pack(device, tables(device, False), items, 32, 20, False)
    prep_s = time.perf_counter() - t0
    seg_d = cuda_banded.SEG_D[32]
    ck, tk, lo, hi = k3_run(pack, True, seg_d)
    if lo.numel() == 0:
        raise AssertionError("K3 deep pack: no posterior above threshold")
    f_ms, b_ms = k3_times(pack, True, seg_d, 0.01, lo.numel())
    d_max = deepest(pack)
    out = {"shape": f"{n} x lx 30000-70000, W=32, S={seg_d}, LUT",
           "rows": pack.n_rows, "words": lo.numel(), "prep_s": prep_s,
           "deepest_diagonals": d_max}
    for name, ms, sweep in (("K3-fwd", f_ms, "fwd"), ("K3-bwd", b_ms, "bwd")):
        bms, by = bound_ms(*k3_work(pack, True, sweep, seg_d, lo.numel()))
        out[name] = {"ms": ms, "bound_ms": bms, "bound_by": by,
                     "ns_per_diagonal": ms * 1e6 / d_max}
        log(f"{name} deep pack ({out['shape']}, {pack.n_rows} rows): kernel "
            f"{ms:.1f} ms, bound {bms:.3f} ms ({by}); deepest {d_max} "
            f"diagonals, {ms * 1e6 / d_max:.1f} ns per diagonal")
    return out


def torch_sync():
    import torch
    torch.cuda.synchronize()


class Recorder:
    """For the main-path run: sums each kernel's device time from CUDA
    events recorded on the launch stream right before and after its C
    launch call (so the wrappers' host-side checks are not counted), and
    keeps the largest input each kernel was given. The launch counters
    stay the wrappers' own. Counts the calls of banded.extract_packed, the
    torch-op extraction, which the production route no longer makes (K2-bwd
    WORDS emits the words)."""

    def __init__(self):
        from margin_tpu_torch.ops import cuda_banded, pairhmm
        self.pairhmm, self.cuda_banded = pairhmm, cuda_banded
        from margin_tpu_torch.ops import banded
        self.banded = banded
        self.orig = (pairhmm.forward_total, cuda_banded.fb_forward,
                     pairhmm._k1_lib, cuda_banded._k2, cuda_banded._k3,
                     cuda_banded._k5, cuda_banded.fb_posteriors_seg,
                     cuda_banded.fb_backward_words, banded.extract_packed)
        self.events = {"K1": [], "K2-fwd": [], "K2-bwd": [],
                       "K2-bwd WORDS": [], "K3-fwd": [], "K3-bwd": [],
                       "K4": [], "K5-fwd": [], "K5-exp": [],
                       "K5-fwd step": [], "K5-fwd strided": [],
                       "K5-exp step": [], "K5-exp strided": [],
                       "extraction": []}
        self.extract_calls = 0
        self.k1_max = None    # (cells, tables, batch, use_lut)
        self.k1_log = []      # (B, Lx, Ly, RLE, use_lut, lxs, lys) a launch
        self.k2_max = None    # (rows*W, pack, use_lut)
        self.k3_max = None    # (rows*W, fb_posteriors_seg arguments)
        self.threshold = {}   # id(pack) -> extraction threshold

    def _timed(self, name, fn, design=None):
        """fn timed under `name` (and, for K5, under `name design`)."""
        import torch

        def call(*args):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            rc = fn(*args)
            e.record()
            self.events[name].append((s, e))
            if design is not None:
                self.events[f"{name} {design}"].append((s, e))
            return rc
        return call

    def install(self):
        ft, ff, k1, k2, k3, k5, fps, fbw, ext = self.orig
        lib1 = k1()

        class TimedK1:
            k1_forward_total = staticmethod(self._timed(
                "K1", lib1.k1_forward_total))
        lib = k2()
        lib3 = k3()
        lib5 = k5()

        class TimedK2:
            k2_forward = staticmethod(self._timed("K2-fwd", lib.k2_forward))
            k2_backward = staticmethod(self._timed("K2-bwd",
                                                   lib.k2_backward))
            k2_backward_words = staticmethod(self._timed(
                "K2-bwd WORDS", lib.k2_backward_words))
            k2_expectations = staticmethod(self._timed(
                "K4", lib.k2_expectations))

        class TimedK3:
            k3_forward = staticmethod(self._timed("K3-fwd",
                                                  lib3.k3_forward))
            k3_backward = staticmethod(self._timed("K3-bwd",
                                                   lib3.k3_backward))

        class TimedK5:
            k5_forward = staticmethod(self._timed(
                "K5-fwd", lib5.k5_forward, "strided"))
            k5_expectations = staticmethod(self._timed(
                "K5-exp", lib5.k5_expectations, "strided"))
            k5_step_forward = staticmethod(self._timed(
                "K5-fwd", lib5.k5_step_forward, "step"))
            k5_step_expectations = staticmethod(self._timed(
                "K5-exp", lib5.k5_step_expectations, "step"))

        def fb_posteriors_seg(*args, **kw):
            out = fps(*args, **kw)
            pack = out[1]
            if self.k3_max is None or pack.n_rows * pack.W > self.k3_max[0]:
                self.k3_max = (pack.n_rows * pack.W, args, kw)
            return out

        def forward_total(tables, batch, use_lut=False):
            size = batch.xs.shape[0] * (batch.xs.shape[1]
                                        + batch.ys.shape[1]) * \
                (batch.ys.shape[1] + 1)
            if self.k1_max is None or size > self.k1_max[0]:
                self.k1_max = (size, tables, batch, use_lut)
            if batch.xs.shape[0]:   # a launch (B = 0 launches nothing)
                self.k1_log.append((*batch.xs.shape, batch.ys.shape[1],
                                    tables.repeat is not None
                                    and batch.rep_x is not None,
                                    bool(use_lut), batch.lxs, batch.lys))
            return ft(tables, batch, use_lut)

        def fb_forward(pack, use_lut):
            if self.k2_max is None or pack.n_rows * pack.W > self.k2_max[0]:
                self.k2_max = (pack.n_rows * pack.W, pack, use_lut)
            return ff(pack, use_lut)

        def fb_backward_words(pack, fwd, totals, use_lut, threshold, *a,
                              **kw):
            if self.k2_max is not None and pack is self.k2_max[1]:
                self.threshold[id(pack)] = threshold
            return fbw(pack, fwd, totals, use_lut, threshold, *a, **kw)

        timed_ext = self._timed("extraction", ext)

        def extract_packed(post, totals, pack, threshold):
            self.extract_calls += 1
            return timed_ext(post, totals, pack, threshold)
        self.pairhmm.forward_total = forward_total
        self.cuda_banded.fb_forward = fb_forward
        self.pairhmm._k1_lib = lambda: TimedK1
        self.cuda_banded._k2 = lambda: TimedK2
        self.cuda_banded._k3 = lambda: TimedK3
        self.cuda_banded._k5 = lambda: TimedK5
        self.cuda_banded.fb_posteriors_seg = fb_posteriors_seg
        self.cuda_banded.fb_backward_words = fb_backward_words
        self.banded.extract_packed = extract_packed

    def restore(self):
        (self.pairhmm.forward_total, self.cuda_banded.fb_forward,
         self.pairhmm._k1_lib, self.cuda_banded._k2, self.cuda_banded._k3,
         self.cuda_banded._k5, self.cuda_banded.fb_posteriors_seg,
         self.cuda_banded.fb_backward_words,
         self.banded.extract_packed) = self.orig

    def no_extraction(self, run):
        """Raise if the run called the torch-op extraction: on the card
        K2-bwd WORDS emits the words of every K2 pack."""
        if self.extract_calls:
            raise AssertionError(f"{run}: extract_packed ran "
                                 f"{self.extract_calls} times on the "
                                 "production route")

    def kernel_ms(self):
        torch_sync()
        return {k: sum(s.elapsed_time(e) for s, e in v)
                for k, v in self.events.items()}

    def k1_launches(self, run):
        """Keep the run's K1 launches (batch shape, RLE, logAdd, each pair's
        lx and ly) for chiprun_out/k1_launches.json, log them by padded Ly
        with their summed device ms and return that summary."""
        kms = [s.elapsed_time(e) for s, e in self.events["K1"]]
        if len(kms) != len(self.k1_log):
            raise AssertionError(f"{run}: {len(kms)} K1 launches, "
                                 f"{len(self.k1_log)} through forward_total")
        launches = [{"B": B, "Lx": Lx, "Ly": Ly, "rle": rle, "lut": lut,
                     "lxs": lxs.tolist(), "lys": lys.tolist()}
                    for B, Lx, Ly, rle, lut, lxs, lys in self.k1_log]
        K1_LAUNCH_LOG[run] = launches
        summary = {}
        for lo, hi in K1_LY_BUCKETS:
            sel = [(l, ms) for l, ms in zip(launches, kms)
                   if lo <= l["Ly"] <= hi]
            summary[f"Ly {lo}..{hi}"] = {
                "launches": len(sel), "pairs": sum(l["B"] for l, _ in sel),
                "max_Lx": max((l["Lx"] for l, _ in sel), default=0),
                "ms": sum(ms for _, ms in sel)}
        log(f"{run} K1 launches by padded Ly: {summary}")
        return summary


# padded-Ly ranges K1 launches are counted in: a block of one warp, of
# R = 1 row a lane (up to 32 warps), R = 2, R = 4 or 8
K1_LY_BUCKETS = ((0, 31), (32, 1023), (1024, 2047), (2048, 8191))
K1_LAUNCH_LOG = {}   # run -> its K1 launches (Recorder.k1_launches)


def run_cli(argv, log_path):
    from margin_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch_sync()
    wall = time.perf_counter() - t0
    with open(log_path, "a") as fh:
        fh.write(buf.getvalue())
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}; log in {log_path}")
    return wall


def accuracy(ds, base):
    """(phased share of the true het sites, haplotag agreement with the
    simulated origin on tagged reads, tagged reads)."""
    import struct
    from margin_tpu_torch.io import bam as bamio
    phased = total = 0
    with open(f"{base}.phased.vcf") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            total += 1
            phased += line.split("\t")[9].split(":")[0] in ("0|1", "1|0")
    agree = tagged = 0
    with bamio.BamReader(f"{base}.haplotagged.bam") as r:
        for rec in r:
            blob = rec.tags_blob()
            i = blob.find(b"HPi")
            if i < 0:
                continue
            hp = struct.unpack_from("<i", blob, i + 3)[0]
            tagged += 1
            agree += hp == ds.read_hap[rec.name]
    share = agree / max(tagged, 1)
    # haplotype labels are arbitrary: score the better of the two
    return phased / max(total, 1), max(share, 1 - share), tagged


def phase_dataset(work, contig_len=1_000_000, n_snv=1000, n_sv=30):
    """The seeded synthetic phase set of phase 3 (and scripts/
    phase_trace.py)."""
    from margin_tpu_torch.testing.synth import SynthConfig, write_dataset
    return write_dataset(work, SynthConfig(
        contig_len=contig_len, coverage=30.0, read_len=(5000, 30000),
        n_snv=n_snv, n_sv=n_sv, sv_len=(50, 2000), sv_short_fraction=2 / 3,
        sv_short_max=500, sv_min_gap=min(27_000, contig_len // (n_sv + 1)),
        p_sub=0.03, p_ins=0.02, p_del=0.03, sv_handling=50,
        sv_expansion=1024, seed=7))


# what a trace's spans wrap: (span name, module, function), each where the
# checkout has it (the extraction's torch ops before K2-bwd WORDS, then
# the WORDS instance's wrapper with its read of the count)
TRACE_SPANS = (("extraction", "margin_tpu_torch.ops.banded",
                "extract_packed"),
               ("K2-bwd WORDS", "margin_tpu_torch.ops.cuda_banded",
                "fb_backward_words"))
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def trace_summary(path, wall_s):
    """Summary of a torch.profiler chrome trace: device events, the
    device's busy time (the union of kernel, copy and set intervals) and
    its share of the traced window and of the run's wall, the device time
    by kernel name, and each TRACE_SPANS span's host time beside the
    device time of the work launched inside it (runtime calls matched to
    device events by correlation id)."""
    import bisect
    with open(path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    t_lo = min(e["ts"] for e in events)
    t_hi = max(e["ts"] + e["dur"] for e in events)
    busy = union_us([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_name = {}
    for e in dev:
        n = e.get("name", "?")[:60]
        ms, k = by_name.get(n, (0.0, 0))
        by_name[n] = (ms + e["dur"] / 1e3, k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    dev_by_corr = {}
    for e in dev:
        c = e.get("args", {}).get("correlation")
        if c is not None:
            dev_by_corr[c] = dev_by_corr.get(c, 0.0) + e["dur"]
    runtime = sorted((e["ts"], e.get("args", {}).get("correlation"))
                     for e in events
                     if e.get("cat") in ("cuda_runtime", "cuda_driver"))
    r_ts = [t for t, _ in runtime]
    spans = {}
    for name, _, _ in TRACE_SPANS:
        wins = [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") == "user_annotation" and e["name"] == name]
        dev_us = 0.0
        for a, b in wins:
            for i in range(bisect.bisect_left(r_ts, a),
                           bisect.bisect_right(r_ts, b)):
                dev_us += dev_by_corr.get(runtime[i][1], 0.0)
        if wins:
            spans[name] = {"calls": len(wins),
                           "host_ms": sum(b - a for a, b in wins) / 1e3,
                           "device_ms": dev_us / 1e3}
    window = (t_hi - t_lo) / 1e6
    # no device event: the profiler did not trace the card (busy share not
    # measured), not a fault of the run
    seen = bool(dev)
    return {"device_events": len(dev), "window_s": window, "wall_s": wall_s,
            "busy_s": busy / 1e6 if seen else None,
            "busy_share_of_window": busy / 1e6 / window if seen else None,
            "busy_share_of_wall": busy / 1e6 / wall_s if seen else None,
            "device_ms_by_kernel": {n: {"ms": ms, "events": k}
                                    for n, (ms, k) in top},
            "spans": spans}


def traced(fn, path):
    """Run fn() under torch.profiler (CPU and CUDA activities), each
    TRACE_SPANS function the checkout has wrapped in a record_function
    span of its name; write the chrome trace to path and return
    (fn's seconds, trace_summary)."""
    import importlib
    from torch.profiler import ProfilerActivity, profile, record_function
    saved = []
    for name, mod_name, fn_name in TRACE_SPANS:
        mod = importlib.import_module(mod_name)
        real = getattr(mod, fn_name, None)
        if real is None:
            continue

        def span(*a, _real=real, _name=name, **kw):
            with record_function(_name):
                return _real(*a, **kw)
        saved.append((mod, fn_name, real))
        setattr(mod, fn_name, span)
    try:
        torch_sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch_sync()
            secs = time.perf_counter() - t0
        prof.export_chrome_trace(path)
    finally:
        for mod, fn_name, real in saved:
            setattr(mod, fn_name, real)
    return secs, trace_summary(path, secs)


def log_trace(label, tr):
    spans = "; ".join(f"{n}: {v['calls']} calls, host {v['host_ms']:.1f} "
                      f"ms, device {v['device_ms']:.2f} ms"
                      for n, v in tr["spans"].items())
    if not tr["device_events"]:
        log(f"{label} under torch.profiler: wall {tr['wall_s']:.1f} s; no "
            "device event traced (busy share not measured)")
        return
    top = list(tr["device_ms_by_kernel"].items())[:6]
    log(f"{label} under torch.profiler: wall {tr['wall_s']:.1f} s, "
        f"{tr['device_events']} device events, device busy "
        f"{tr['busy_s']:.3f} s = {tr['busy_share_of_wall']:.4f} of the "
        f"wall ({tr['busy_share_of_window']:.4f} of the traced window "
        f"{tr['window_s']:.1f} s); {spans or 'no span'}; top device ms "
        f"{ {k: round(v['ms'], 1) for k, v in top} }")


def phase_e2e(device, work, out_dir, contig_len=1_000_000, n_snv=1000,
              n_sv=30, region_len=200_000):
    from margin_tpu_torch.ops import banded, cuda_banded, pairhmm
    t0 = time.perf_counter()
    ds = phase_dataset(work, contig_len, n_snv, n_sv)
    gen_s = time.perf_counter() - t0
    n_sv_true = sum(v.kind != "snv" for v in ds.variants)
    log(f"dataset: {contig_len} bp, {len(ds.read_hap)} reads, "
        f"{len(ds.variants)} het variants ({n_sv_true} SVs), "
        f"generated in {gen_s:.1f} s")
    log_path = os.path.join(out_dir, "chip_smoke_phase.log")
    common = [ds.bam, ds.fasta, ds.params, ds.vcf, "--device", device]

    # --- the main path: counters zeroed right before, read right after
    from margin_tpu_torch.parallel.executor import DEVICE_STATS
    rec = Recorder()
    rec.install()
    zero_counters()
    try:
        wall = run_cli(["phase"] + common + ["-o", f"{work}/full",
                                            "--profile"], log_path)
    finally:
        rec.restore()
    launches = {"K1": pairhmm.FORWARD_TOTAL.launches,
                "K2-fwd": cuda_banded.FB_FORWARD.launches,
                "K2-bwd": cuda_banded.FB_BACKWARD.launches,
                "K2-bwd WORDS": cuda_banded.FB_WORDS.launches}
    routes = {"k2_items": banded.ROUTES.pack_items,
              "host_items": banded.ROUTES.host_items,
              "packs": banded.ROUTES.packs}
    scoring = DEVICE_STATS.snapshot()
    kms = rec.kernel_ms()
    k1l = rec.k1_launches("phase")
    with open(f"{work}/full.profile.json") as fh:
        prof = json.load(fh)
    phased, agree, tagged = accuracy(ds, f"{work}/full")
    log(f"phase 1 Mb: wall {wall:.1f} s; launches {launches}; kernel ms "
        f"{ {k: round(v, 1) for k, v in kms.items()} }; SV items: "
        f"{routes['k2_items']} on K2 in {routes['packs']} packs, "
        f"{routes['host_items']} on the host engine; phased "
        f"{phased:.3f} of true hets; haplotag agreement {agree:.4f} on "
        f"{tagged} reads")
    log(f"scoring calls (dense batches + banded packs): {scoring}")
    log(f"stages: {prof.get('stages_s')}; chunk stages: "
        f"{prof.get('chunk_stage_totals_s')}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    rec.no_extraction("phase 1 Mb")
    if phased < 0.5:
        raise AssertionError(f"only {phased:.3f} of the het sites phased")
    if agree < 0.9:
        raise AssertionError(f"haplotag agreement {agree:.4f} < 0.9")

    # --- the same run again under torch.profiler: the device's busy share
    # and the pack read-back's host wait (not the measured wall)
    _, trace = traced(lambda: run_cli(["phase"] + common + [
        "-o", f"{work}/traced", "-a", "CRITICAL"], log_path),
        os.path.join(work, "phase_trace.json"))
    log_trace("phase 1 Mb", trace)

    # --- a sub-region through the kernels, then through the plain twins
    mid = contig_len // 2
    region = (f"{ds.contig}:{mid - region_len // 2 + 1}-"
              f"{mid + region_len // 2}")
    t0 = time.perf_counter()
    with fused_hmm_capture():
        run_cli(["phase"] + common + ["-o", f"{work}/kern", "-r", region,
                                      "-a", "CRITICAL"], log_path)
    kern_s = time.perf_counter() - t0

    def check():
        same_files(f"{work}/kern", f"{work}/plain",
                   ("phased.vcf", "phaseset.bed"))
        return {"region": region, "kernel_s": kern_s,
                "verdict": "phased VCF and phaseset.bed byte-identical"}
    queue_twin(f"phase {region}", {"kind": "cli", "argv": [
        "phase"] + common + ["-o", f"{work}/plain", "-r", region, "-a",
                             "CRITICAL"]}, check)
    log(f"{region}: kernels {kern_s:.1f} s (twins queued)")
    return {"wall_s": wall, "launches": launches, "routes": routes,
            "kernel_ms": kms, "k1_launches": k1l, "scoring": scoring,
            "trace": trace, "phased_share": phased,
            "haplotag_agreement": agree, "tagged_reads": tagged,
            "profile": prof, "region": region, "region_kernel_s": kern_s,
            "dataset_s": gen_s}, rec, ds


def phase_main_path_shapes(rec):
    """Each kernel against its twin on the largest input the main path
    gave it, and the extraction's time on K2's."""
    from margin_tpu_torch.ops import banded, cuda_banded, pairhmm
    out = {}
    _, tabs, batch, lut = rec.k1_max
    got = pairhmm.forward_total(tabs, batch, use_lut=lut)
    torch_sync()
    t0 = time.perf_counter()
    want = pairhmm.forward_total_plain(tabs, batch, use_lut=lut)
    torch_sync()
    p1 = (time.perf_counter() - t0) * 1e3
    d1 = compare("K1 main-path batch", got, want, lut)
    ops, nbytes = k1_work(batch, tabs, lut)
    bms, by = bound_ms(ops, nbytes)
    shape = f"B={batch.xs.shape[0]} Lx={batch.xs.shape[1]} " \
        f"Ly={batch.ys.shape[1]}"
    ms = cuda_ms(lambda: pairhmm.forward_total(tabs, batch, lut))
    d_max = k1_diagonals(batch)
    out["K1"] = {"shape": shape, "max_abs_err": d1, "ms": ms,
                 "plain_ms": p1, "bound_ms": bms, "bound_by": by,
                 "deepest_diagonals": d_max,
                 "ns_per_diagonal": ms * 1e6 / d_max}
    _, pack, lut = rec.k2_max
    fk, tk = cuda_banded.fb_forward(pack, lut)
    pk = cuda_banded.fb_backward(pack, fk, tk, lut)
    t0 = time.perf_counter()
    fp, tp = cuda_banded.fb_forward_plain(pack, lut)
    torch_sync()
    pf = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pp = cuda_banded.fb_backward_plain(pack, fp, tp, lut)
    torch_sync()
    pb = (time.perf_counter() - t0) * 1e3
    d_f = max(compare("K2 main-path totals", tk, tp, lut),
              compare("K2-fwd main-path grid", fk, fp, lut))
    d_b = compare("K2-bwd main-path posteriors", pk, pp, lut)
    shape = f"B={pack.B} rows={pack.n_rows} W={pack.W}"
    d_max = deepest(pack)
    for name, sweep, pms, diff, fn in (
            ("K2-fwd", "fwd", pf, d_f,
             lambda: cuda_banded.fb_forward(pack, lut)),
            ("K2-bwd", "bwd", pb, d_b,
             lambda: cuda_banded.fb_backward(pack, fk, tk, lut))):
        bms, by = bound_ms(*k2_work(pack, lut, sweep))
        ms = cuda_ms(fn)
        out[name] = {"shape": shape, "max_abs_err": diff, "ms": ms,
                     "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                     "deepest_diagonals": d_max,
                     "ns_per_diagonal": ms * 1e6 / d_max}
    # K4 on the same pack, beside K2-bwd (the same walk, expectations in
    # place of posteriors)
    ms = cuda_ms(lambda: cuda_banded.fb_expectations(pack, fk, tk, lut))
    bms, by = bound_ms(*k4_work(pack, lut))
    out["K4 on K2's pack"] = {
        "shape": shape, "ms": ms, "bound_ms": bms, "bound_by": by,
        "deepest_diagonals": d_max, "ns_per_diagonal": ms * 1e6 / d_max}
    for k, v in out.items():
        if "plain_ms" not in v:
            log(f"{k} ({v['shape']}): kernel {v['ms']:.3f} ms, bound "
                f"{v['bound_ms']:.4f} ms ({v['bound_by']}); "
                f"{v['ns_per_diagonal']:.1f} ns per diagonal")
            continue
        per_diag = ("" if "ns_per_diagonal" not in v else
                    f"; deepest {v['deepest_diagonals']} diagonals, "
                    f"{v['ns_per_diagonal']:.1f} ns per diagonal")
        log(f"{k} on the main path's largest input ({v['shape']}): kernel "
            f"{v['ms']:.3f} ms, plain {v['plain_ms']:.1f} ms, bound "
            f"{v['bound_ms']:.4f} ms ({v['bound_by']}), max|diff| "
            f"{v['max_abs_err']}{per_diag}")
    # K2-bwd WORDS on the same pack, at the threshold the run gave it:
    # against extract_packed on K2-bwd POST's grid and against its twin,
    # timed beside it
    threshold = rec.threshold.get(id(pack), 0.01)
    lo, hi = words_against(pack, fk, tk, pk, lut, threshold,
                           f"the phase run's largest pack ({shape})")
    n_words = lo.numel()
    t0 = time.perf_counter()
    lp, hp = cuda_banded.fb_words_plain(pack, fp, tp, lut, threshold)
    torch_sync()
    pw = (time.perf_counter() - t0) * 1e3
    d_w = compare_words("K2-bwd WORDS against its twin, the phase run's "
                        f"largest pack ({shape})", word_set(tk, lo, hi),
                        word_set(tp, lp, hp), lut)
    ms = cuda_ms(lambda: cuda_banded.fb_backward_words(pack, fk, tk, lut,
                                                       threshold))
    bms, by = bound_ms(*words_work(pack, lut, n_words))
    out["K2-bwd WORDS"] = {
        "shape": shape, "threshold": threshold, "words": n_words,
        "max_abs_err": d_w, "ms": ms, "plain_ms": pw, "bound_ms": bms,
        "bound_by": by, "deepest_diagonals": d_max,
        "ns_per_diagonal": ms * 1e6 / d_max}
    log(f"K2-bwd WORDS on the same pack, threshold {threshold}: kernel "
        f"{ms:.3f} ms for {n_words} words (K2-bwd POST "
        f"{out['K2-bwd']['ms']:.3f} ms), plain {pw:.1f} ms, bound "
        f"{bms:.4f} ms ({by}), {ms * 1e6 / d_max:.1f} ns per diagonal; "
        "words equal extract_packed's on K2-bwd POST's grid and the twin's")
    # the torch-op extraction the WORDS instance replaced (no longer on the
    # path), on K2-bwd POST's grid; bound: the grid read once, the count,
    # totals and words written once
    ms = cuda_ms(lambda: banded.extract_packed(pk, tk, pack, threshold))
    bms, by = bound_ms(0, pack.n_rows * 3 * pack.W * 4 + 4 + 4 * pack.B
                       + 8 * n_words)
    out["extraction"] = {"shape": shape, "threshold": threshold,
                         "words": n_words, "ms": ms, "bound_ms": bms,
                         "bound_by": by}
    log(f"extraction (ops/banded.py:extract_packed, torch ops, off the "
        f"path) on K2-bwd POST's grid of the same pack: {ms:.3f} ms, bound "
        f"{bms:.4f} ms ({by})")
    return out


def zero_counters():
    from margin_tpu_torch.ops import banded, cuda_banded, pairhmm, rphmm_fb
    from margin_tpu_torch.parallel.executor import DEVICE_STATS
    banded.ROUTES.reset()
    DEVICE_STATS.reset()
    for c in (pairhmm.FORWARD_TOTAL, cuda_banded.FB_FORWARD,
              cuda_banded.FB_BACKWARD, cuda_banded.FB_WORDS,
              cuda_banded.SEG_FORWARD, cuda_banded.SEG_BACKWARD,
              cuda_banded.FB_EXPECT, rphmm_fb.RPHMM_FB):
        c.launches = 0
    cuda_banded.FB_FORWARD_WIDE.reset()
    cuda_banded.FB_EXPECT_WIDE.reset()


def read_counters():
    """The launch counters of the banded and dense kernels (K2-bwd counts
    every launch of its backward + posterior walk, K2-bwd WORDS those of
    its WORDS instance)."""
    from margin_tpu_torch.ops import cuda_banded, pairhmm
    return {"K1": pairhmm.FORWARD_TOTAL.launches,
            "K2-fwd": cuda_banded.FB_FORWARD.launches,
            "K2-bwd": cuda_banded.FB_BACKWARD.launches,
            "K2-bwd WORDS": cuda_banded.FB_WORDS.launches,
            "K3-fwd": cuda_banded.SEG_FORWARD.launches,
            "K3-bwd": cuda_banded.SEG_BACKWARD.launches}


def fasta_seq(path):
    with open(path) as fh:
        return "".join(line.strip() for line in fh if not line.startswith(">"))


def polish_dataset(work, span=120_000):
    """The seeded haploid polish set of phases 6, 7 and the em, helen and
    tools phases (with truth.bam)."""
    from margin_tpu_torch.testing.synth import (PolishSynthConfig,
                                                write_polish_dataset)
    return write_polish_dataset(f"{work}/polish", PolishSynthConfig(
        contig_len=span, coverage=30.0, read_len=(5000, 30000), p_sub=0.03,
        p_ins=0.02, p_del=0.03, chunk_size=100_000, chunk_boundary=1000,
        seed=11))


def phase_polish(device, work, out_dir, span=120_000):
    """`margin polish` end to end on a seeded synthetic draft."""
    from margin_tpu_torch.ops import banded
    from margin_tpu_torch.parallel.executor import DEVICE_STATS
    from margin_tpu_torch.testing.synth import banded_edit_distance
    t0 = time.perf_counter()
    ds = polish_dataset(work, span)
    gen_s = time.perf_counter() - t0
    log(f"polish dataset: {span} bp draft with {len(ds.draft_edits)} "
        f"edits, generated in {gen_s:.1f} s")
    log_path = os.path.join(out_dir, "chip_smoke_polish.log")
    rec = Recorder()
    rec.install()
    zero_counters()
    try:
        wall = run_cli(["polish", ds.bam, ds.draft, ds.params, "-o",
                        f"{work}/pol", "--device", device, "--profile"],
                       log_path)
    finally:
        rec.restore()
    launches = read_counters()
    rec.no_extraction("polish")
    routes = {"k2_items": banded.ROUTES.pack_items,
              "k3_items": banded.ROUTES.seg_items,
              "host_items": banded.ROUTES.host_items,
              "k2_packs": banded.ROUTES.packs,
              "k3_packs": banded.ROUTES.seg_packs}
    scoring = DEVICE_STATS.snapshot()
    kms = rec.kernel_ms()
    k1l = rec.k1_launches("polish")
    with open(f"{work}/pol.profile.json") as fh:
        prof = json.load(fh)
    truth, draft = fasta_seq(ds.truth), fasta_seq(ds.draft)
    polished = fasta_seq(f"{work}/pol.fa")
    t0 = time.perf_counter()
    # the band follows the line between the two ends; a banded distance
    # is an upper bound, so the check below cannot pass by its error
    ed_draft = banded_edit_distance(draft, truth, 300)
    ed_pol = banded_edit_distance(polished, truth, 300)
    ed_s = time.perf_counter() - t0
    log(f"polish {span} bp: wall {wall:.1f} s; launches {launches}; kernel "
        f"ms { {k: round(v, 1) for k, v in kms.items()} }; routes {routes}; "
        f"edit distance to the truth: draft {ed_draft}, polished {ed_pol} "
        f"(lengths {len(truth)} / {len(draft)} / {len(polished)}; "
        f"{ed_s:.1f} s)")
    log(f"polish stages: {prof.get('stages_s')}; chunk stages: "
        f"{prof.get('chunk_stage_totals_s')}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels of the polish path never launched: "
                             f"{missing}")
    if routes["k3_items"] == 0:
        raise AssertionError("no item took the segmented route")
    if not 2 * ed_pol <= ed_draft:
        raise AssertionError(f"polish did not halve the draft's edit "
                             f"distance ({ed_draft} -> {ed_pol})")
    return {"wall_s": wall, "launches": launches, "routes": routes,
            "kernel_ms": kms, "k1_launches": k1l, "scoring": scoring,
            "profile": prof, "edit_distance_draft": ed_draft, "edit_distance_polished": ed_pol,
            "lengths": [len(truth), len(draft), len(polished)],
            "dataset_s": gen_s, "span": span}, ds, rec


def twins():
    """(module, name) -> the plain twin to bind in the kernel wrapper's
    place for a kernels-against-twins rerun."""
    from margin_tpu_torch.ops import cuda_banded, pairhmm
    return {
        (pairhmm, "forward_total"): pairhmm.forward_total_plain,
        (cuda_banded, "fb_forward"): cuda_banded.fb_forward_plain,
        (cuda_banded, "fb_backward"): cuda_banded.fb_backward_plain,
        (cuda_banded, "fb_backward_words"):
            lambda pack, fwd, totals, use_lut, threshold, cap=None,
            chunk=None: cuda_banded.fb_words_plain(pack, fwd, totals,
                                                   use_lut, threshold),
        (cuda_banded, "fb_forward_wide"):
            lambda pack, use_lut, ring_shared=None, design=None:
            cuda_banded.fb_forward_plain(pack, use_lut),
        (cuda_banded, "fb_expectations_wide"):
            lambda pack, fwd, totals, use_lut, ring_shared=None, design=None:
            cuda_banded.fb_expectations_plain(pack, fwd, totals, use_lut),
        (cuda_banded, "seg_forward"): cuda_banded.seg_forward_plain,
        (cuda_banded, "seg_backward"):
            lambda pack, ckpt, totals, use_lut, seg_d, threshold, cap=None:
            cuda_banded.seg_backward_plain(pack, ckpt, totals, use_lut,
                                           seg_d, threshold)}


# ---------------------------------------------------------------------------
# kernels against twins: the twins' runs, concurrent subprocesses at the end
# ---------------------------------------------------------------------------

TWIN_JOBS = []   # (label, spec, check): queued by the phases
# the polish, diploid and HELEN twins' regions: a twin walks one diagonal
# at a time, so these runs take most of phase 15 (10 kb took 264 s)
TWIN_REGION_LEN = 5_000


def queue_twin(label, spec, check):
    """Queue a run through the plain twins (spec: see twin_job) and the
    check that compares its outputs with the kernels' run."""
    TWIN_JOBS.append((label, spec, check))


def polish_run(bam, draft, params, out, region=None, diploid=False,
               truth_bam=None, feature_type=None, seg_min_d=None,
               device="cuda"):
    """run_polish in process on the kernels (or on whatever is bound in
    their place). HELEN features, if asked for, are kept in memory (a
    helen.HelenArrays bound in HelenHDF5File's place: h5py is not on
    every card machine) and then pickled to <out>.features.pkl. Returns
    the seconds it took."""
    import pickle
    from margin_tpu_torch.ops import banded
    from margin_tpu_torch.params import Params
    from margin_tpu_torch.polish import helen
    from margin_tpu_torch.polish.driver import run_polish
    sinks = []

    def in_memory(filename):
        sinks.append(helen.HelenArrays())
        return sinks[-1]
    saved = banded.SEG_MIN_D, helen.HelenHDF5File
    if seg_min_d:
        banded.SEG_MIN_D = seg_min_d
    helen.HelenHDF5File = in_memory
    try:
        t0 = time.perf_counter()
        run_polish(bam, draft, Params.load(params), out, region=region,
                   diploid=diploid, use_lut=True, device=device,
                   true_reference_bam=truth_bam, feature_type=feature_type,
                   log=lambda *a: None)
        torch_sync()
        secs = time.perf_counter() - t0
    finally:
        banded.SEG_MIN_D, helen.HelenHDF5File = saved
    if feature_type:
        if len(sinks) != 1:
            raise AssertionError(f"run_polish opened {len(sinks)} HELEN "
                                 "files, not one")
        with open(f"{out}.features.pkl", "wb") as fh:
            pickle.dump(sinks[0].groups, fh)
    return secs


def twin_job(spec):
    """One run with the plain twins bound in the kernel wrappers' place,
    on the card: spec["kind"] "cli" runs cli.main(spec["argv"]), "polish"
    runs polish_run(**spec["args"]); the seconds go to spec["result"]."""
    for (mod, name), fn in twins().items():
        setattr(mod, name, fn)
    t0 = time.perf_counter()
    if spec["kind"] == "cli":
        run_cli(spec["argv"], spec["log"])
    else:
        polish_run(**spec["args"])
    with open(spec["result"], "w") as fh:
        json.dump({"s": time.perf_counter() - t0}, fh)


def run_twin_jobs(work):
    """Run every queued twin run at once, each in a subprocess of its own
    (they share the card: each walks one diagonal at a time with small
    launches), then each phase's check. Returns {label: result}."""
    procs = []
    out = {}
    t0 = time.perf_counter()
    try:
        for i, (label, spec, check) in enumerate(TWIN_JOBS):
            spec = dict(spec, result=f"{work}/twin{i}.json",
                        log=f"{work}/twin{i}.log")
            with open(spec["log"], "w") as fh:
                procs.append((label, spec, check, subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--twin-job", json.dumps(spec)], stdout=fh,
                    stderr=subprocess.STDOUT)))
        for label, spec, check, p in procs:
            if p.wait() != 0:
                with open(spec["log"]) as fh:
                    tail = fh.read()[-3000:]
                raise RuntimeError(f"twin run {label} exited "
                                   f"{p.returncode}:\n{tail}")
    finally:
        for *_, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for label, spec, check, _ in procs:
        with open(spec["result"]) as fh:
            plain_s = json.load(fh)["s"]
        out[label] = dict(check(), plain_s=plain_s)
        log(f"{label}: plain twins {plain_s:.1f} s (concurrent); "
            f"{out[label]['verdict']}")
    log(f"twin runs: {len(procs)} at once in {wall:.1f} s")
    out["wall_s"] = wall
    TWIN_JOBS.clear()
    return out


def same_files(a, b, names):
    """Raise unless each a.<name> equals b.<name> byte for byte."""
    for name in names:
        with open(f"{a}.{name}", "rb") as fa, open(f"{b}.{name}", "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"kernel and plain {name} differ "
                                     f"({a}, {b})")


def same_features(a, b):
    """Raise unless the HELEN groups of two polish_run outputs are equal
    byte for byte; returns (groups, rows)."""
    import pickle
    import numpy as np
    with open(f"{a}.features.pkl", "rb") as fa, \
            open(f"{b}.features.pkl", "rb") as fb:
        ga, gb = pickle.load(fa), pickle.load(fb)
    if ga.keys() != gb.keys():
        raise AssertionError(f"HELEN groups differ: {sorted(ga)[:3]} vs "
                             f"{sorted(gb)[:3]}")
    for g in ga:
        if ga[g].keys() != gb[g].keys() or any(
                ga[g][k].dtype != gb[g][k].dtype
                or not np.array_equal(ga[g][k], gb[g][k]) for k in ga[g]):
            raise AssertionError(f"HELEN group {g} differs")
    return len(ga), sum(len(v["position"]) for v in ga.values())


def mid_region(ds, region_len):
    """The region of region_len bases at the middle of ds's draft."""
    mid = len(fasta_seq(ds.draft)) // 2
    return f"{ds.contig}:{mid - region_len // 2 + 1}-{mid + region_len // 2}"


def phase_polish_region(ds, work, region_len=TWIN_REGION_LEN,
                        device="cuda"):
    """A sub-region in process through the kernels, with channelRleWeight
    HELEN features labelled by truth.bam (-u), then (queued) through the
    plain twins bound in their place: byte-identical FASTA and feature
    arrays and labels. SEG_MIN_D is lowered to 2048 so K3 runs; the
    dataset's own POA-consensus iterations and bubble pass run."""
    from margin_tpu_torch.ops import banded
    from margin_tpu_torch.params import Params
    params = Params.load(ds.params)
    region = mid_region(ds, region_len)
    args = {"bam": ds.bam, "draft": ds.draft, "params": ds.params,
            "region": region, "truth_bam": ds.truth_bam,
            "feature_type": "channelRleWeight", "seg_min_d": 2048,
            "device": device}
    zero_counters()
    kern_s = polish_run(out=f"{work}/rk", **args)
    launches = read_counters()
    seg_items = banded.ROUTES.seg_items
    if launches["K3-fwd"] == 0 or seg_items == 0:
        raise AssertionError(f"{region}: K3 did not run ({launches})")
    iters = params.polish.maxPoaConsensusIterations

    def check():
        same_files(f"{work}/rk", f"{work}/rp", ("fa",))
        groups, rows = same_features(f"{work}/rk", f"{work}/rp")
        if groups == 0:
            raise AssertionError(f"{region}: no HELEN group written")
        return {"region": region, "kernel_s": kern_s, "launches": launches,
                "k3_items": seg_items, "poa_consensus_iterations": iters,
                "helen_groups": groups, "helen_rows": rows,
                "verdict": f"FASTA byte-identical, {groups} channelRleWeight "
                           f"groups ({rows} labelled rows) identical"}
    queue_twin(f"polish {region}", {"kind": "polish", "args": dict(
        args, out=f"{work}/rp")}, check)
    log(f"polish {region} (SEG_MIN_D 2048, POA-consensus iterations "
        f"{iters}, {seg_items} items on K3, launches {launches}, "
        f"channelRleWeight features with -u): kernels {kern_s:.1f} s "
        "(twins queued)")
    return {"region": region, "kernel_s": kern_s, "launches": launches,
            "k3_items": seg_items, "args": args}


def haplotag_agreement(bam, read_hap):
    """(share of HP-tagged reads whose tag is their true haplotype, up to
    one swap: the polish BAM carries no PS tag and the stitched contig is
    one phase set; tagged reads)."""
    import struct
    from margin_tpu_torch.io import bam as bamio
    agree = tagged = 0
    with bamio.BamReader(bam) as r:
        for rec in r:
            blob = rec.tags_blob()
            i = blob.find(b"HPi")
            if i < 0:
                continue
            tagged += 1
            agree += struct.unpack_from("<i", blob, i + 3)[0] \
                == read_hap[rec.name]
    return max(agree, tagged - agree) / max(tagged, 1), tagged


def phase_diploid(device, work, out_dir, span=120_000):
    """`margin polish --diploid` end to end on a seeded synthetic diploid
    draft: launches, kernel ms, routes, stages, haplotag agreement, and
    each haplotype FASTA's edit distance to each truth haplotype."""
    from margin_tpu_torch.ops import banded
    from margin_tpu_torch.parallel.executor import DEVICE_STATS
    from margin_tpu_torch.testing.synth import (DiploidPolishSynthConfig,
                                                banded_edit_distance,
                                                write_diploid_polish_dataset)
    t0 = time.perf_counter()
    ds = write_diploid_polish_dataset(
        f"{work}/diploid", DiploidPolishSynthConfig(
            contig_len=span, coverage=30.0, read_len=(5000, 30000),
            p_sub=0.03, p_ins=0.02, p_del=0.03, chunk_size=100_000,
            chunk_boundary=1000, seed=13))
    gen_s = time.perf_counter() - t0
    log(f"diploid dataset: {span} bp, {len(ds.hets)} het sites, "
        f"{len(ds.draft_edits)} draft edits, {len(ds.read_hap)} reads, "
        f"generated in {gen_s:.1f} s")
    log_path = os.path.join(out_dir, "chip_smoke_diploid.log")
    rec = Recorder()
    rec.install()
    zero_counters()
    try:
        wall = run_cli(["polish", ds.bam, ds.draft, ds.params, "-o",
                        f"{work}/dip", "--diploid", "--device", device,
                        "--profile"], log_path)
    finally:
        rec.restore()
    launches = read_counters()
    rec.no_extraction("diploid polish")
    routes = {"k2_items": banded.ROUTES.pack_items,
              "k3_items": banded.ROUTES.seg_items,
              "host_items": banded.ROUTES.host_items,
              "k2_packs": banded.ROUTES.packs,
              "k3_packs": banded.ROUTES.seg_packs}
    scoring = DEVICE_STATS.snapshot()
    kms = rec.kernel_ms()
    k1l = rec.k1_launches("diploid")
    words = words_on_largest(rec, "the diploid run's largest K2 pack")
    with open(f"{work}/dip.profile.json") as fh:
        prof = json.load(fh)
    agree, tagged = haplotag_agreement(f"{work}/dip.haplotagged.bam",
                                       ds.read_hap)
    t0 = time.perf_counter()
    seqs = {"draft": fasta_seq(ds.draft),
            "hap1": fasta_seq(f"{work}/dip.hap1.fa"),
            "hap2": fasta_seq(f"{work}/dip.hap2.fa")}
    truths = {"truth1": fasta_seq(ds.truth1), "truth2": fasta_seq(ds.truth2)}
    # banded distances are upper bounds (see phase_polish)
    ed = {f"{a}-{b}": banded_edit_distance(seqs[a], truths[b], 300)
          for a in seqs for b in truths}
    ed_s = time.perf_counter() - t0
    log(f"diploid polish {span} bp: wall {wall:.1f} s; launches {launches}; "
        f"kernel ms { {k: round(v, 1) for k, v in kms.items()} }; routes "
        f"{routes}; haplotag agreement {agree:.4f} on {tagged} reads; edit "
        f"distances {ed} ({ed_s:.1f} s)")
    log(f"diploid stages: {prof.get('stages_s')}; chunk stages: "
        f"{prof.get('chunk_stage_totals_s')}")
    log(f"diploid device ms: { {k: round(v, 1) for k, v in kms.items()} }")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels of the diploid path never launched: "
                             f"{missing}")
    if agree < 0.9:
        raise AssertionError(f"diploid haplotag agreement {agree:.4f} < 0.9")
    return {"wall_s": wall, "launches": launches, "routes": routes,
            "kernel_ms": kms, "k1_launches": k1l, "scoring": scoring,
            "profile": prof, "haplotag_agreement": agree, "tagged_reads": tagged,
            "edit_distances": ed, "words_check": words,
            "lengths": {k: len(v) for k, v in {**seqs, **truths}.items()},
            "dataset_s": gen_s, "span": span}, ds


def bam_records(path):
    from margin_tpu_torch.io import bam as bamio
    with bamio.BamReader(path) as r:
        return [(rec.name, rec.flag, rec.pos, rec.tags_blob()) for rec in r]


def phase_diploid_region(ds, work, region_len=TWIN_REGION_LEN,
                         device="cuda"):
    """Diploid polish of a sub-region in process through the kernels with
    the truth haplotypes riding along (-u truth.bam), then (queued)
    through the plain twins bound in their place (SEG_MIN_D lowered to
    2048 so K3 runs): identical hap FASTAs, haplotagged BAM records and
    truth-haplotype partition."""
    from margin_tpu_torch.ops import banded
    region = mid_region(ds, region_len)
    args = {"bam": ds.bam, "draft": ds.draft, "params": ds.params,
            "region": region, "diploid": True, "truth_bam": ds.truth_bam,
            "seg_min_d": 2048, "device": device}
    zero_counters()
    kern_s = polish_run(out=f"{work}/dk", **args)
    launches = read_counters()
    seg_items = banded.ROUTES.seg_items
    if launches["K1"] == 0 or launches["K3-fwd"] == 0 or seg_items == 0:
        raise AssertionError(f"{region}: K1 or K3 did not run ({launches})")
    with open(f"{work}/dk.truthHaplotypesPartition.tsv") as fh:
        rows = [ln.split("\t") for ln in fh if not ln.startswith("#")]
    if sorted(r[6].strip() for r in rows) != ["truth1", "truth2"] \
            or rows[0][5] == rows[1][5]:
        raise AssertionError(f"{region}: truth haplotypes not split "
                             f"between the haplotypes: {rows}")

    def check():
        same_files(f"{work}/dk", f"{work}/dp",
                   ("hap1.fa", "hap2.fa", "truthHaplotypesPartition.tsv"))
        recs = bam_records(f"{work}/dk.haplotagged.bam")
        if recs != bam_records(f"{work}/dp.haplotagged.bam"):
            raise AssertionError(f"{region}: kernel and plain haplotagged "
                                 "BAM records differ")
        return {"region": region, "kernel_s": kern_s, "launches": launches,
                "k3_items": seg_items, "bam_records": len(recs),
                "verdict": f"hap FASTAs, truth partition and {len(recs)} "
                           "haplotagged BAM records identical"}
    queue_twin(f"diploid polish {region}", {"kind": "polish", "args": dict(
        args, out=f"{work}/dp")}, check)
    log(f"diploid polish {region} (SEG_MIN_D 2048, {seg_items} items on "
        f"K3, launches {launches}, -u: truth1 on hap {rows[0][5]}, truth2 "
        f"on hap {rows[1][5]}): kernels {kern_s:.1f} s (twins queued)")
    return {"region": region, "kernel_s": kern_s, "launches": launches,
            "k3_items": seg_items}


def words_on_largest(rec, label, timed=False):
    """K2-bwd WORDS against extract_packed on K2-bwd POST's grid, on the
    largest K2 pack a run launched, at the run's threshold; timed: also
    the device times of K2-bwd WORDS, of K2-bwd POST and of the torch-op
    extraction on its grid there."""
    from margin_tpu_torch.ops import banded, cuda_banded
    _, pack, lut = rec.k2_max
    threshold = rec.threshold.get(id(pack), 0.01)
    fk, tk = cuda_banded.fb_forward(pack, lut)
    pk = cuda_banded.fb_backward(pack, fk, tk, lut)
    shape = f"B={pack.B} rows={pack.n_rows} W={pack.W}"
    lo, _ = words_against(pack, fk, tk, pk, lut, threshold,
                          f"{label} ({shape})")
    out = {"shape": shape, "threshold": threshold, "words": lo.numel()}
    if timed:
        out["ms"] = {
            "K2-bwd WORDS": cuda_ms(lambda: cuda_banded.fb_backward_words(
                pack, fk, tk, lut, threshold)),
            "K2-bwd": cuda_ms(lambda: cuda_banded.fb_backward(pack, fk, tk,
                                                              lut)),
            "extraction": cuda_ms(lambda: banded.extract_packed(
                pk, tk, pack, threshold))}
        out["bound_ms"] = bound_ms(*words_work(pack, lut, lo.numel()))
    log(f"K2-bwd WORDS on {label} ({shape}, threshold {threshold}): "
        f"{lo.numel()} words, equal to extract_packed's on K2-bwd POST's "
        "grid" + (f"; device ms {out['ms']}, bound {out['bound_ms']}"
                  if timed else ""))
    return out


def phase_k3_main_path(rec, max_b=16):
    """K3 on the largest K3 pack of the polish run: timed, and held against
    K2 (identical words and totals), on the whole pack, with K2-fwd /
    K2-bwd timed on it in the same call; held
    against its twin, and timed beside it, on the pack's max_b shallowest
    problems."""
    from margin_tpu_torch.ops import cuda_banded
    _, args, kw = rec.k3_max
    (tabs, items, w_pad, expansion, use_lut, dynamic, use_rle, threshold,
     seg_d) = args[:9]
    geoms = kw.get("geoms_in")

    def pack_of(keep):
        return cuda_banded._pack_host(
            tabs, [items[i] for i in keep], w_pad, expansion, dynamic,
            use_rle, None if geoms is None else [geoms[i] for i in keep],
            device=tabs.device)
    full = pack_of(range(len(items)))
    label = f"B={full.B} rows={full.n_rows} W={w_pad} S={seg_d}"
    rows = {r["kernel"]: r for r in k3_against(full, use_lut, seg_d, label,
                                               threshold, twin=False)}
    d_max = deepest(full)
    # the same pack through K2, timed in this call
    budget = cuda_banded.FB_GRID_BUDGET_BYTES
    cuda_banded.FB_GRID_BUDGET_BYTES = max(
        budget, cuda_banded.grid_bytes(full.n_rows, full.W))
    try:
        fk, tk2 = cuda_banded.fb_forward(full, use_lut)
        k2f = cuda_ms(lambda: cuda_banded.fb_forward(full, use_lut), reps=3)
        k2b = cuda_ms(lambda: cuda_banded.fb_backward(full, fk, tk2, use_lut),
                      reps=3)
    finally:
        cuda_banded.FB_GRID_BUDGET_BYTES = budget
    del fk
    for name, k2name, ms in (("K3-fwd", "K2-fwd", k2f),
                             ("K3-bwd", "K2-bwd", k2b)):
        ratio = ms / rows[name]["ms"]
        rows[name].update({"k2_same_pack_ms": ms,
                           "k2_ns_per_diagonal": ms * 1e6 / d_max,
                           "k2_over_k3": ratio})
        log(f"{k2name} on the same pack ({label}): {ms:.2f} ms, "
            f"{ms * 1e6 / d_max:.1f} ns per diagonal (K3: "
            f"{rows[name]['ms']:.2f} ms); {k2name} / {name} {ratio:.3f}")
    del full
    order = sorted(range(len(items)),
                   key=lambda i: len(items[i]["x_sym"])
                   + len(items[i]["y_sym"]))
    trim = pack_of(order[:max_b])
    tlabel = (f"the {trim.B} shallowest, rows={trim.n_rows} W={w_pad} "
              f"S={seg_d}")
    for r in k3_against(trim, use_lut, seg_d, tlabel, threshold):
        row = rows[r["kernel"]]
        row.update({"max_abs_err": r["max_abs_err"],
                    "plain_ms": r["plain_ms"], "plain_shape": tlabel,
                    "ms_on_plain_shape": r["ms"],
                    "bound_ms_on_plain_shape": r["bound_ms"]})
    return {k: {f: v for f, v in r.items() if f != "kernel"}
            for k, r in rows.items()}


# ---------------------------------------------------------------------------
# EM: the transition expectations K4
# ---------------------------------------------------------------------------

def k4_ops_per_cell(lut):
    """K4's float ops per band cell: the backward's three states (the
    posteriors' 12 ops left out) plus nine expectations of five ops each
    (f + to, + transition, - total, exp, the running sum's add)."""
    return bwd_ops_per_cell(lut) - 12 + 9 * 5


def k4_work(pack, lut):
    """K4 on a pack: its cell operations; the inputs, the forward grid and
    the totals read once, the (B, 3, 3) expectations written once."""
    from margin_tpu_torch.ops import banded
    cells = sum(banded._true_band_cells(g) for g in pack.geoms)
    nbytes = (pack_input_bytes(pack) + pack.n_rows * 3 * pack.W * 4
              + 4 * pack.B + 36 * pack.B)
    return cells * k4_ops_per_cell(lut), nbytes


def compare_expectations(name, got, want):
    """K4 against its twin: rtol 1e-5 with an absolute floor of 1e-7 x
    each matrix's sum. Returns (max |diff|, the largest |diff| as a share
    of its entry's tolerance)."""
    tol = 1e-5 * want.abs() + 1e-7 * want.sum(dim=(1, 2), keepdim=True)
    diff = (got - want).abs()
    worst = float((diff / tol.clamp(min=1e-30)).max())
    if not bool((diff <= tol).all()) or not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: expectations beyond rtol 1e-5 / atol "
                             f"1e-7 x sum (worst at {worst:.2f} x the "
                             "tolerance)")
    return float(diff.max()), worst


def em_read_pairs(ds, n, expansion, seed=21):
    """n read-to-draft pairs cut from the polish set: a read segment of
    1-4 kb against the draft window its true alignment (the BAM's CIGAR)
    puts it on, with the read's strand, anchored on that alignment's
    aligned pairs as polish anchors a read's first realignment. Returns
    [(x_sym, y_sym, strand, anchors)]."""
    import numpy as np
    from margin_tpu_torch.alphabet import seq_to_symbols
    from margin_tpu_torch.io import bam as bamio
    rng = np.random.default_rng(seed)
    draft = seq_to_symbols(fasta_seq(ds.draft))
    with bamio.BamReader(ds.bam) as r:
        recs = [rec for rec in r if not rec.is_unmapped]
    pairs = []
    while len(pairs) < n:
        rec = recs[int(rng.integers(0, len(recs)))]
        # the reference and read position of every aligned (M) base
        rp, qp = [], []
        ref, qry = rec.pos, 0
        for op, ln in rec.cigar_ops():
            if op in (0, 7, 8):
                rp.append(np.arange(ref, ref + ln))
                qp.append(np.arange(qry, qry + ln))
            ref += ln if op in (0, 2, 3, 7, 8) else 0
            qry += ln if op in (0, 1, 4, 7, 8) else 0
        rp, qp = np.concatenate(rp), np.concatenate(qp)
        span = int(rng.integers(1000, 4001))
        if rp[-1] - rp[0] < span:
            continue
        r0 = int(rng.integers(rp[0], rp[-1] - span + 1))
        i0 = int(np.searchsorted(rp, r0))
        i1 = int(np.searchsorted(rp, r0 + span)) - 1
        x = draft[rp[i0]:rp[i1] + 1]
        y = seq_to_symbols(rec.seq()[qp[i0]:qp[i1] + 1])
        anchors = [(int(a), int(b), expansion) for a, b in
                   zip(rp[i0:i1 + 1] - rp[i0], qp[i0:i1 + 1] - qp[i0])]
        pairs.append((x, y, int(rec.is_reverse), anchors))
    return pairs


def kmer_anchored(pairs, expansion):
    """The pairs re-anchored on their shared kmers
    (get_kmer_alignment_anchors), as margin's EM anchors them
    (getExpectationsUsingAnchors), with each band's width."""
    from margin_tpu_torch.ops import banded
    from margin_tpu_torch.polish.kmers import get_kmer_alignment_anchors
    out = []
    for x, y, strand, _ in pairs:
        a = get_kmer_alignment_anchors(x, y, expansion)
        w = banded.BandGeometry.build(a, len(x), len(y), expansion,
                                      smooth=True).w_pad
        out.append((x, y, strand, a, w))
    return out


def live_warp_share(pairs, expansion):
    """The share of the warp-diagonals of K5's step blocks that hold a
    cell of their band (k in [k_lo, width)) over kmer_anchored pairs
    wider than 128 cells, each at its pack width: the others skip their
    recurrence (banded_step.cuh:warp_live, which also drops cells outside
    the DP rectangle, so this is an upper bound)."""
    import numpy as np
    from margin_tpu_torch.ops import banded, cuda_banded
    live = total = 0
    for x, y, _, a, w in pairs:
        if w <= 128:
            continue
        g = banded.BandGeometry.build(a, len(x), len(y), expansion,
                                      smooth=True)
        D = len(x) + len(y) + 1
        klo = np.zeros(D) if g.k_lo is None else g.k_lo[:D]
        w0 = 32 * np.arange(cuda_banded.block_warps(banded._round8(w)))
        hit = (w0[:, None] < g.widths[:D]) & (w0[:, None] + 32 > klo)
        live += int(hit.sum())
        total += hit.size
    return live / max(total, 1)


def em_short_pairs(n, seed=22):
    """n anchorless pairs of 60-120 bases: x random, y an erroneous copy
    (test_em's structure at more pairs)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lx = int(rng.integers(60, 121))
        x = rng.integers(0, 4, lx).astype(np.uint8)
        y = x.copy()
        flip = rng.random(lx) < 0.1
        y[flip] = (y[flip] + rng.integers(1, 4, int(flip.sum()))) % 4
        out.append((x, y[rng.random(lx) > 0.05]))
    return out


def k4_against(tabs, groups, expansion, lut, label):
    """K4 on the packs banded.expectation_packs makes of each group of
    items (the packs the main path launches it on, where it solves the
    group in one call), each held against its twin, and K2-fwd's totals
    against theirs; K4 timed on the deepest of those packs, beside its
    twin's time on that pack, its bound and its ns per diagonal."""
    from margin_tpu_torch.ops import banded, cuda_banded
    checked = []
    for group in groups:
        for _, pack in banded.expectation_packs(tabs, group, expansion):
            fk, tk = cuda_banded.fb_forward(pack, lut)
            ek = cuda_banded.fb_expectations(pack, fk, tk, lut)
            fp, tp = cuda_banded.fb_forward_plain(pack, lut)
            torch_sync()
            t0 = time.perf_counter()
            ep = cuda_banded.fb_expectations_plain(pack, fk, tk, lut)
            torch_sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
            shape = (f"B={pack.B} rows={pack.n_rows} W={pack.W}, deepest "
                     f"{deepest(pack)} diagonals")
            compare(f"K2-fwd totals, {label} {shape}", tk, tp, lut)
            diff, share = compare_expectations(f"K4 {label} {shape}", ek,
                                               ep)
            checked.append({"pack": pack, "fwd": fk, "totals": tk,
                            "shape": shape, "max_abs_err": diff,
                            "tolerance_share": share, "plain_ms": plain_ms})
    top = max(checked, key=lambda c: (deepest(c["pack"]), c["pack"].n_rows))
    pack = top["pack"]
    ms = cuda_ms(lambda: cuda_banded.fb_expectations(
        pack, top["fwd"], top["totals"], lut))
    bms, by = bound_ms(*k4_work(pack, lut))
    d_max = deepest(pack)
    diff = max(c["max_abs_err"] for c in checked)
    share = max(c["tolerance_share"] for c in checked)
    log(f"K4 {label} {'LUT' if lut else 'exact'}: kernel {ms:.3f} ms on "
        f"{top['shape']}, twin {top['plain_ms']:.0f} ms there, bound "
        f"{bms:.4f} ms ({by}), {ms * 1e6 / d_max:.1f} ns per diagonal; "
        f"held against the twin on {len(checked)} packs "
        f"({'; '.join(c['shape'] for c in checked)}), max|diff| {diff:.3g}, "
        f"at most {share:.3f} of an entry's tolerance")
    return {"shape": top["shape"], "lut": lut, "max_abs_err": diff,
            "ms": ms, "plain_ms": top["plain_ms"], "bound_ms": bms,
            "bound_by": by, "deepest_diagonals": d_max,
            "ns_per_diagonal": ms * 1e6 / d_max,
            "tolerance_share": share,
            "checked": [(c["shape"], c["max_abs_err"], c["tolerance_share"])
                        for c in checked]}


def k5_work(pack, lut, sweep):
    """K5 on a pack: K5-fwd the forward's cell operations, the inputs
    read and the grid and totals written once (K2-fwd's count); K5-exp
    K4's (the same walk and sums)."""
    if sweep == "exp":
        return k4_work(pack, lut)
    from margin_tpu_torch.ops import banded
    cells = sum(banded._true_band_cells(g) for g in pack.geoms)
    return (cells * fwd_ops_per_cell(lut), pack_input_bytes(pack)
            + pack.n_rows * 3 * pack.W * 4 + 4 * pack.B)


def k5_designs(w):
    """The K5 designs that serve a pack of width w: K2's step (where
    cuda_banded.k5_design gives it, the main path's choice) and the
    strided kernel, which serves any width."""
    from margin_tpu_torch.ops import cuda_banded
    return (("step", "strided") if cuda_banded.k5_design(w) == "step"
            else ("strided",))


def k5_hold(pack, lut, label):
    """Each K5 design that serves the pack's width held against the plain
    twins on it: K5-fwd's grid and totals (LUT: identical bits; exact:
    within 1e-4), K5-exp (on the twin's forward) within K4's tolerance;
    the strided design again with its ring in device memory (identical
    to the shared ring's). Then each design timed (cuda_ms, as every
    kernel of the kernels line), with ns a diagonal of the deepest problem
    and the bound of the pack's work."""
    import torch
    from margin_tpu_torch.ops import cuda_banded
    torch_sync()
    t0 = time.perf_counter()
    fp, tp = cuda_banded.fb_forward_plain(pack, lut)
    torch_sync()
    pf = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ep = cuda_banded.fb_expectations_plain(pack, fp, tp, lut)
    torch_sync()
    pe = (time.perf_counter() - t0) * 1e3
    d_max = deepest(pack)
    shape = (f"B={pack.B} rows={pack.n_rows} W={pack.W} RLE "
             f"{'on' if pack.rep_x is not None else 'off'}, deepest "
             f"{d_max} diagonals")
    out = {"shape": shape, "W": pack.W, "lut": lut, "plain_fwd_ms": pf,
           "plain_exp_ms": pe, "deepest_diagonals": d_max, "designs": {}}
    bounds = {sweep: bound_ms(*k5_work(pack, lut, sweep))
              for sweep in ("fwd", "exp")}
    for design in k5_designs(pack.W):
        name = f"K5 {design}, {label} {shape} {'LUT' if lut else 'exact'}"
        fk, tk = cuda_banded.fb_forward_wide(pack, lut, design=design)
        ek = cuda_banded.fb_expectations_wide(pack, fp, tp, lut,
                                              design=design)
        torch_sync()
        d_f = max(compare(f"{name}: K5-fwd totals", tk, tp, lut),
                  compare(f"{name}: K5-fwd grid", fk, fp, lut))
        diff, share = compare_expectations(f"{name}: K5-exp", ek, ep)
        if design == "strided":
            fd, td = cuda_banded.fb_forward_wide(pack, lut, False, design)
            ed = cuda_banded.fb_expectations_wide(pack, fp, tp, lut, False,
                                                  design)
            if not (torch.equal(fd, fk) and torch.equal(td, tk)
                    and torch.equal(ed, ek)):
                raise AssertionError(f"{name}: the device-memory ring "
                                     "gives other values")
            del fd, ed
        del fk, ek
        fms = cuda_ms(lambda: cuda_banded.fb_forward_wide(
            pack, lut, design=design))
        ems = cuda_ms(lambda: cuda_banded.fb_expectations_wide(
            pack, fp, tp, lut, design=design))
        out["designs"][design] = {
            "fwd_ms": fms, "exp_ms": ems, "fwd_err": d_f,
            "max_abs_err": diff, "tolerance_share": share,
            "fwd_ns_per_diagonal": fms * 1e6 / d_max,
            "exp_ns_per_diagonal": ems * 1e6 / d_max}
        log(f"{name}: K5-fwd {fms:.3f} ms ({fms * 1e6 / d_max:.1f} ns a "
            f"diagonal), K5-exp {ems:.3f} ms ({ems * 1e6 / d_max:.1f} ns);"
            f" twins {pf:.0f} / {pe:.0f} ms; bounds {bounds['fwd'][0]:.4f}"
            f" / {bounds['exp'][0]:.4f} ms ({bounds['fwd'][1]}); max|diff| "
            f"fwd {d_f:.3g}, exp {diff:.3g} at {share:.3f} of an entry's "
            "tolerance")
    out["bounds"] = {k: {"bound_ms": v[0], "bound_by": v[1]}
                     for k, v in bounds.items()}
    return out


def k5_shares(held):
    """The largest expectation tolerance share of each design over k5_hold
    results."""
    return {d: max(h["designs"][d]["tolerance_share"] for h in held
                   if d in h["designs"]) for d in ("step", "strided")
            if any(d in h["designs"] for h in held)}


def k5_row(held, name):
    """The kernels line's numbers of K5-fwd or K5-exp from a k5_hold
    result: the design the main path takes at that width."""
    from margin_tpu_torch.ops import cuda_banded
    design = cuda_banded.k5_design(held["W"])
    d = held["designs"][design]
    sweep = "fwd" if name == "K5-fwd" else "exp"
    ms = d[f"{sweep}_ms"]
    return {"shape": held["shape"], "lut": held["lut"], "design": design,
            "max_abs_err": d["fwd_err"] if sweep == "fwd"
            else d["max_abs_err"], "ms": ms,
            "plain_ms": held[f"plain_{sweep}_ms"],
            "bound_ms": held["bounds"][sweep]["bound_ms"],
            "bound_by": held["bounds"][sweep]["bound_by"],
            "deepest_diagonals": held["deepest_diagonals"],
            "ns_per_diagonal": ms * 1e6 / held["deepest_diagonals"]}


def k5_against(tabs, groups, expansion, lut, label):
    """K5 on the packs banded.expectation_packs makes of each group (the
    packs add_expectations launches it on: a pair alone): each design
    held against the twins and timed there (k5_hold). The kernels line
    takes the deepest pack's numbers of the main path's design."""
    from margin_tpu_torch.ops import banded
    held = []
    for group in groups:
        for _, pack in banded.expectation_packs(tabs, group, expansion):
            if pack.W <= 128:
                raise AssertionError(f"K5 {label}: a pack of W={pack.W}")
            held.append(k5_hold(pack, lut, label))
    top = max(held, key=lambda h: (h["deepest_diagonals"], h["W"]))
    rows = {name: k5_row(top, name) for name in ("K5-fwd", "K5-exp")}
    share = k5_shares(held)
    rows["K5-exp"]["tolerance_share"] = share
    log(f"K5 {label}: both designs held against the twins on {len(held)} "
        f"packs ({'; '.join(h['shape'] for h in held)}): forward grids and "
        f"totals {'identical' if lut else 'within 1e-4'}, expectations at "
        f"most {share} of an entry's tolerance by design")
    rows["held"] = held
    return rows


# The k5 loop's packs: tests/test_torch_em.py:_k5_pack's three anchored
# problems of 600-1500 bases at these band widths (K2's step up to 512,
# the strided design beyond; anchored every 6 bases, so the band fills
# its width on every diagonal), and the em run's deepest shape, one pair
# of ~7950 diagonals at W = 208, anchored every 6 bases and on its kmers.
K5_WIDTHS = (136, 208, 256, 424, 512, 640, 1057)


def k5_pack(device, w, rle, lxs=(1500, 600, 1100)):
    """Problems of lengths lxs (the first strand 0, then alternating;
    the second ragged left, the third ragged right), y an erroneous copy
    of x anchored every 6 bases at expansion w - 7, whose bands are about
    w cells wide, packed at their widest band rounded up to 8."""
    import numpy as np
    from margin_tpu_torch.ops import banded, cuda_banded
    rng = np.random.default_rng(60 + w)
    exp = w - 7
    items = []
    for i, lx in enumerate(lxs):
        x = rng.integers(0, 4, lx).astype(np.int32)
        y = x.copy()
        flip = rng.random(lx) < 0.08
        y[flip] = (y[flip] + rng.integers(1, 4, int(flip.sum()))) % 4
        keep = rng.random(lx) > 0.04
        ypos = np.cumsum(keep) - 1
        y = y[keep]
        xa = np.nonzero(keep)[0][::6][1:-1]
        it = {"x_sym": x, "y_sym": y, "strand": i % 2,
              "ragged_left": i == 1, "ragged_right": i == 2,
              "anchors": [(int(a), int(ypos[a]), exp) for a in xa]}
        if rle:
            it["rep_x"] = rng.integers(1, 12, lx).astype(np.int32)
            it["rep_y"] = rng.integers(1, 12, len(y)).astype(np.int32)
        items.append(it)
    geoms = [banded._item_geom(it, exp, False) for it in items]
    w_pad = banded._round8(max(g.w_pad for g in geoms))
    return cuda_banded._pack_host(tables(device, rle), items, w_pad, exp,
                                  False, rle, geoms, device=device)


def k5_kmer_pack(device, lx=4000, seed=25, expansion=20):
    """One read-like pair anchored on its kmers as margin's EM anchors it
    (the em phase's shape): x of lx random bases, y a copy with 3%
    substitutions, 3% deletions and 2% insertions, packed at its band
    width rounded up to 8 (seed 25: 7935 diagonals, W = 208). Along such
    a band its own width moves far below W."""
    import numpy as np
    from margin_tpu_torch.ops import banded, cuda_banded
    from margin_tpu_torch.polish.kmers import get_kmer_alignment_anchors
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, lx)
    y = []
    for c in x:
        r = rng.random()
        if r < 0.03:
            continue
        y.append((c + rng.integers(1, 4)) % 4 if r < 0.06 else c)
        if rng.random() < 0.02:
            y.append(rng.integers(0, 4))
    it = {"x_sym": x.astype(np.int32), "y_sym": np.array(y, np.int32),
          "strand": 0}
    it["anchors"] = get_kmer_alignment_anchors(it["x_sym"], it["y_sym"],
                                               expansion)
    geom = banded._item_geom(it, expansion, False)
    return cuda_banded._pack_host(tables(device, False), [it],
                                  banded._round8(geom.w_pad), expansion,
                                  False, False, [geom], device=device)


def phase_k5(device):
    """K5's loop: each design on every pack of K5_WIDTHS, RLE off and on,
    and on the deep pairs (RLE off), both logAdds, held against the twins
    and timed (k5_hold); then each design's largest tolerance share and
    the step design's time as a share of the strided one's."""
    from margin_tpu_torch import _ext
    log(f"k5: banded_wide built in "
        f"{_ext.BUILD_SECONDS.get('banded_wide', 0.0):.1f} s, banded_fb in "
        f"{_ext.BUILD_SECONDS.get('banded_fb', 0.0):.1f} s")
    packs = [(f"W {w}", k5_pack(device, w, rle))
             for w in K5_WIDTHS for rle in (False, True)]
    packs.append(("the deep pair", k5_pack(device, 208, False, (4060,))))
    packs.append(("the deep kmer pair", k5_kmer_pack(device)))
    rows = []
    for label, pack in packs:
        for lut in (True, False):
            rows.append(k5_hold(pack, lut, label))
    share = k5_shares(rows)
    ratios = [(r["shape"], r["lut"],
               round(r["designs"]["step"]["fwd_ms"]
                     / r["designs"]["strided"]["fwd_ms"], 3),
               round(r["designs"]["step"]["exp_ms"]
                     / r["designs"]["strided"]["exp_ms"], 3))
              for r in rows if "step" in r["designs"]]
    log(f"k5: {len(rows)} packs x logAdds held; largest tolerance share by "
        f"design {share}; step / strided ms (fwd, exp): {ratios}")
    return {"rows": rows, "tolerance_share": share, "ratios": ratios}


def em_checks(name, hmm):
    """The accumulated expectations and likelihood of a read-to-draft EM
    pass are in range; a read-to-draft pair aligns mostly by matches."""
    import numpy as np
    E = hmm.trans
    if not (np.isfinite(E).all() and (E >= 0).all()
            and np.isfinite(hmm.likelihood) and hmm.likelihood < 0):
        raise AssertionError(f"EM {name}: expectations or likelihood out "
                             "of range")
    if not E[0, 0] > 0.5 * E.sum():
        raise AssertionError(f"EM {name}: match -> match {E[0, 0]} of "
                             f"{E.sum()}")


def phase_em(ds, n_reads=1024, n_short=256, n_plain=16, n_deep=2,
             device="cuda"):
    """Baum-Welch EM through the port's entry points: 1024 read-to-draft
    pairs of 1-4 kb through HmmExpectations.add_expectations on kmer
    anchors, as margin's EM anchors them (getExpectationsUsingAnchors,
    the polish params' diagonalExpansion, each pair on its strand, RLE
    off): every band wider than 128 cells on K5-fwd and K5-exp, the
    narrower on K2-fwd and K4; then the same pairs anchored on their
    alignments (bands of <= 32 cells: K2-fwd and K4), then em_iteration
    over 256 anchorless pairs of 60-120 bases (expansion 20), LUT and
    exact. The launch counters are zeroed right before and read right
    after each pass. Then K5 is held against its twin on the widest and
    the deepest kmer-anchored pair (each alone, as add_expectations
    launches it), timed on the deeper; K4 on the 16 shallowest
    alignment-anchored pairs (one pack) and on each of the 2 deepest
    alone, timed on the deepest, and on every pack em_iteration
    launched."""
    import numpy as np
    from margin_tpu_torch.ops import banded, cuda_banded, em
    from margin_tpu_torch.params import Params
    from margin_tpu_torch.ops import pairhmm
    pp = Params.load(ds.params).polish
    expansion = pp.p.diagonalExpansion
    tabs = pairhmm.PairHmmTables.from_params(pp.sm_forward, pp.sm_reverse,
                                             device=device)
    t0 = time.perf_counter()
    reads = em_read_pairs(ds, n_reads, expansion)
    shorts = em_short_pairs(n_short)
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kmer = kmer_anchored(reads, expansion)
    kmer_s = time.perf_counter() - t0
    widths = sorted(w for *_, w in kmer)
    n_wide = sum(w > 128 for w in widths)
    live = live_warp_share(kmer, expansion)
    log(f"em: {n_reads} read-to-draft pairs on kmer anchors ({kmer_s:.1f} "
        f"s): {n_wide} bands wider than 128 cells (widths {widths[0]}.."
        f"{widths[len(widths) // 2]}..{widths[-1]}: min, median, max); at "
        f"most {live:.3f} of their step blocks' warp-diagonals hold a band "
        "cell")

    # --- the main path: EM on kmer anchors
    rec = Recorder()
    rec.install()
    zero_counters()
    try:
        t0 = time.perf_counter()
        hmm_k = em.HmmExpectations(1e-12)
        for x, y, strand, a, _ in kmer:
            hmm_k.add_expectations(tabs, x, y, a, expansion, strand,
                                   use_lut=True)
        torch_sync()
        kmer_run_s = time.perf_counter() - t0
    finally:
        rec.restore()
    k_launches = {"K2-fwd": cuda_banded.FB_FORWARD.launches,
                  "K4": cuda_banded.FB_EXPECT.launches,
                  "K5-fwd": cuda_banded.FB_FORWARD_WIDE.launches,
                  "K5-exp": cuda_banded.FB_EXPECT_WIDE.launches}
    k_designs = {"K5-fwd": dict(cuda_banded.FB_FORWARD_WIDE.designs),
                 "K5-exp": dict(cuda_banded.FB_EXPECT_WIDE.designs)}
    k_kms = {k: v for k, v in rec.kernel_ms().items()
             if k.split(" ")[0] in k_launches}
    # the design of each wide pair's launches, from its pack width
    want = {d: sum(cuda_banded.k5_design(banded._round8(w)) == d
                   for w in widths if w > 128)
            for d in cuda_banded.K5_DESIGNS}
    if not (k_launches["K5-fwd"] == k_launches["K5-exp"] == n_wide > 0
            and k_designs["K5-fwd"] == k_designs["K5-exp"] == want):
        raise AssertionError(f"EM on kmer anchors: {n_wide} wide pairs "
                             f"({want} by design), launches {k_launches}, "
                             f"by design {k_designs}")
    if k_launches["K4"] != n_reads - n_wide:
        raise AssertionError(f"EM on kmer anchors: {n_reads - n_wide} "
                             f"narrow pairs, launches {k_launches}")
    em_checks("on kmer anchors", hmm_k)
    log(f"em on kmer anchors: {n_reads} pairs through add_expectations in "
        f"{kmer_run_s:.1f} s; launches {k_launches}, K5's by design "
        f"{k_designs}; device ms "
        f"{ {k: round(v, 2) for k, v in k_kms.items()} }; E (from, to) "
        f"{np.round(hmm_k.trans / hmm_k.trans.sum(), 5).tolist()}, "
        f"likelihood {hmm_k.likelihood:.1f}")

    # --- the same pairs on their alignments' anchors, and em_iteration
    rec = Recorder()
    rec.install()
    zero_counters()
    try:
        t0 = time.perf_counter()
        hmm = em.HmmExpectations(1e-12)
        for x, y, strand, a in reads:
            hmm.add_expectations(tabs, x, y, a, expansion, strand,
                                 use_lut=True)
        torch_sync()
        reads_s = time.perf_counter() - t0
        sm = pp.sm_forward
        iters = {}
        for lut in (True, False):
            t0 = time.perf_counter()
            sm1, like = em.em_iteration(sm, shorts, expansion=20,
                                        use_lut=lut, device=device)
            torch_sync()
            iters["LUT" if lut else "exact"] = {
                "s": time.perf_counter() - t0, "likelihood": like,
                "transitions": np.exp(sm1.transition_vector()).tolist()}
    finally:
        rec.restore()
    launches = {"K2-fwd": cuda_banded.FB_FORWARD.launches,
                "K4": cuda_banded.FB_EXPECT.launches}
    kms = {k: v for k, v in rec.kernel_ms().items() if k in launches}
    E = hmm.trans
    if launches["K4"] == 0 or launches["K2-fwd"] == 0:
        raise AssertionError(f"EM did not launch K2-fwd and K4: {launches}")
    em_checks("on the alignments' anchors", hmm)
    for name, it in iters.items():
        if not (np.isfinite(it["likelihood"]) and it["likelihood"] < 0):
            raise AssertionError(f"em_iteration ({name}): likelihood "
                                 f"{it['likelihood']}")
    log(f"em: {n_reads} read-to-draft pairs on their alignments' anchors "
        f"through add_expectations in {reads_s:.1f} s (prep {prep_s:.1f} "
        f"s), em_iteration over {n_short} pairs: "
        f"{ {k: round(v['s'], 2) for k, v in iters.items()} } s; launches "
        f"{launches}; device ms { {k: round(v, 2) for k, v in kms.items()} }"
        f"; E (from, to) {np.round(E / E.sum(), 5).tolist()}")
    # K5 where the kmer-anchored pass launched it: the widest and the
    # deepest wide pair, each alone
    wide = [i for i, (*_, w) in enumerate(kmer) if w > 128]
    kitems = [{"x_sym": kmer[i][0], "y_sym": kmer[i][1],
               "anchors": kmer[i][3], "strand": kmer[i][2]} for i in wide]
    widest = max(range(len(wide)), key=lambda j: kmer[wide[j]][4])
    deepest_i = max(range(len(wide)), key=lambda j: len(kitems[j]["x_sym"])
                    + len(kitems[j]["y_sym"]))
    k5 = k5_against(tabs, [[kitems[j]] for j in sorted({widest, deepest_i})],
                    expansion, True, "kmer-anchored read-to-draft pairs")
    # add_expectations launches K4 on each read pair alone; em_iteration
    # on its packs of the short pairs
    items = [{"x_sym": x, "y_sym": y, "anchors": a, "strand": s}
             for x, y, s, a in reads]
    order = sorted(range(len(items)), key=lambda i: len(items[i]["x_sym"])
                   + len(items[i]["y_sym"]))
    rows = [k4_against(tabs, [[items[i] for i in order[:n_plain]]]
                       + [[items[i]] for i in order[-n_deep:]], expansion,
                       True, "read-to-draft pairs")]
    for lut in (True, False):
        rows.append(k4_against(
            pairhmm.PairHmmTables.from_params(pp.sm_forward, device=device),
            [[{"x_sym": x, "y_sym": y, "anchors": [], "strand": 0}
              for x, y in shorts]], 20, lut, "em_iteration's packs"))
    return {"launches": launches, "kernel_ms": kms, "reads_s": reads_s,
            "prep_s": prep_s, "em_iterations": iters,
            "expectations": E.tolist(), "likelihood": hmm.likelihood,
            "kmer": {"launches": k_launches, "designs": k_designs,
                     "kernel_ms": k_kms,
                     "s": kmer_run_s, "anchor_s": kmer_s,
                     "live_warp_share": live,
                     "band_widths": widths, "wide_pairs": n_wide,
                     "expectations": hmm_k.trans.tolist(),
                     "likelihood": hmm_k.likelihood},
            "k5": k5, "k4": rows}


# ---------------------------------------------------------------------------
# HELEN features and the aux tools
# ---------------------------------------------------------------------------

def phase_helen(ds, work, device="cuda", region_len=51_000):
    """HELEN features: splitRleWeight labelled by truth.bam (-f -F
    splitRleWeight -u) on the first region_len bases of the polish set
    (one chunk: the truth alignment is one K3 problem of about 76k
    diagonals), kernels only, counters zeroed right before and read right
    after, at least one feature row a base of the region; then
    simpleWeight with -u on the set's params with run-length encoding
    off, on a TWIN_REGION_LEN region through the kernels and (queued)
    through the twins: identical feature arrays and labels."""
    import numpy as np
    from margin_tpu_torch.ops import banded
    from margin_tpu_torch.polish import helen
    truth_items = []
    orig = banded.banded_posteriors

    def banded_posteriors(tables, x_sym, y_sym, *a, **kw):
        truth_items.append(len(x_sym) + len(y_sym) + 1)
        return orig(tables, x_sym, y_sym, *a, **kw)
    region = f"{ds.contig}:1-{region_len}"
    zero_counters()
    banded.banded_posteriors = banded_posteriors
    try:
        wall = polish_run(ds.bam, ds.draft, ds.params, f"{work}/hc",
                          region=region, truth_bam=ds.truth_bam,
                          feature_type="splitRleWeight", device=device)
    finally:
        banded.banded_posteriors = orig
    launches = read_counters()
    routes = {"k2_items": banded.ROUTES.pack_items,
              "k3_items": banded.ROUTES.seg_items,
              "host_items": banded.ROUTES.host_items}
    import pickle
    with open(f"{work}/hc.features.pkl", "rb") as fh:
        groups = pickle.load(fh)
    rows = sum(len(g["position"]) for g in groups.values())
    if not groups or rows < region_len:
        raise AssertionError(f"HELEN wrote {len(groups)} groups, {rows} rows")
    position = np.concatenate([g["position"] for g in groups.values()])
    labels = np.concatenate([g["label_base"].ravel()
                             for g in groups.values()])
    consensus = position[:, 1] == 0      # insert position 0
    cons_nt = float((labels[consensus] > 0).mean())
    log(f"helen splitRleWeight -u on {region}: wall {wall:.1f} s; launches "
        f"{launches}; routes {routes}; truth alignments of "
        f"{truth_items} diagonals; {len(groups)} groups, {rows} rows "
        f"({consensus.mean():.4f} of them consensus rows); nucleotide "
        f"labels on {cons_nt:.5f} of the consensus rows and "
        f"{(labels[~consensus] > 0).mean():.5f} of the insert rows")
    if not truth_items or max(truth_items) <= banded.SEG_MIN_D \
            or launches["K3-fwd"] == 0:
        raise AssertionError("the truth alignment did not take K3")
    # a consensus row is labelled with its truth base unless the polished
    # consensus holds a base the truth lacks (well under 1% here)
    if not cons_nt > 0.99:
        raise AssertionError(f"HELEN labels: only {cons_nt:.4f} of the "
                             "consensus rows are nucleotides")

    # simpleWeight needs run-length encoding off
    with open(ds.params) as fh:
        p = json.load(fh)
    p["polish"]["useRunLengthEncoding"] = False
    norle = f"{work}/params_norle.json"
    with open(norle, "w") as fh:
        json.dump(p, fh)
    sregion = mid_region(ds, TWIN_REGION_LEN)
    args = {"bam": ds.bam, "draft": ds.draft, "params": norle,
            "region": sregion, "truth_bam": ds.truth_bam,
            "feature_type": "simpleWeight", "seg_min_d": 2048,
            "device": device}
    zero_counters()
    kern_s = polish_run(out=f"{work}/hsk", **args)
    slaunch = read_counters()

    def check():
        n, r = same_features(f"{work}/hsk", f"{work}/hsp")
        if n == 0:
            raise AssertionError(f"{sregion}: no simpleWeight group written")
        return {"region": sregion, "kernel_s": kern_s, "launches": slaunch,
                "helen_groups": n, "helen_rows": r,
                "verdict": f"{n} simpleWeight groups ({r} labelled rows) "
                           "identical"}
    queue_twin(f"helen simpleWeight {sregion}", {"kind": "polish",
               "args": dict(args, out=f"{work}/hsp")}, check)
    log(f"helen simpleWeight -u on {sregion} (RLE off, SEG_MIN_D 2048, "
        f"launches {slaunch}): kernels {kern_s:.1f} s (twins queued)")
    return {"wall_s": wall, "region": region, "launches": launches,
            "routes": routes, "truth_alignment_diagonals": truth_items,
            "groups": len(groups), "rows": rows,
            "simple_region": sregion, "simple_kernel_s": kern_s}


def phased_truth_vcf(ds, path):
    """ds's variants phased by their true haplotypes, one phase set."""
    with open(ds.vcf) as fh:
        lines = fh.read().splitlines()
    out, i = [], 0
    for line in lines:
        if line.startswith("##FORMAT"):
            out += [line, '##FORMAT=<ID=PS,Number=1,Type=Integer,'
                          'Description="Phase set">']
        elif line.startswith("#"):
            out.append(line)
        else:
            f = line.split("\t")
            f[8:10] = ["GT:PS", ("1|0" if ds.variants[i].hap == 1
                                 else "0|1") + ":1"]
            out.append("\t".join(f))
            i += 1
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")
    return path


def phase_tools(phase_ds, phase_out, region, polish_ds, work, out_dir,
                device="cuda"):
    """The aux tools: tagFromPhasedVcf on the phase run's phased VCF over
    the 200 kb sub-region, through the kernels (K1, counters zeroed right
    before and read right after) and (queued) through the twins:
    identical haplotagged BAM records; runLengthMatrix (10 kb of the
    polish set), tagFromIds (the polish set's reads) and
    calcLocalPhasingCorrectness (the phase run's VCF against the true
    phasing) once each, on the host."""
    import math
    import numpy as np
    log_path = os.path.join(out_dir, "chip_smoke_tools.log")
    argv = ["tagFromPhasedVcf", phase_ds.bam, phase_ds.fasta,
            f"{phase_out}.phased.vcf", phase_ds.params, "-r", region,
            "--device", device]
    zero_counters()
    kern_s = run_cli(argv + ["-o", f"{work}/tk"], log_path)
    launches = read_counters()
    if launches["K1"] == 0:
        raise AssertionError(f"tagFromPhasedVcf did not launch K1: "
                             f"{launches}")
    agree, tagged = haplotag_agreement(f"{work}/tk.haplotagged.bam",
                                       phase_ds.read_hap)

    def check():
        recs = bam_records(f"{work}/tk.haplotagged.bam")
        if recs != bam_records(f"{work}/tp.haplotagged.bam"):
            raise AssertionError(f"tagFromPhasedVcf {region}: kernel and "
                                 "plain haplotagged BAM records differ")
        return {"region": region, "kernel_s": kern_s, "launches": launches,
                "bam_records": len(recs),
                "verdict": f"{len(recs)} haplotagged BAM records identical"}
    queue_twin(f"tagFromPhasedVcf {region}", {"kind": "cli", "argv":
               argv + ["-o", f"{work}/tp"]}, check)
    log(f"tagFromPhasedVcf {region}: kernels {kern_s:.1f} s, launches "
        f"{launches}, haplotag agreement {agree:.4f} on {tagged} reads "
        "(twins queued)")
    out = {"tag_from_phased_vcf": {"kernel_s": kern_s, "launches": launches,
                                   "haplotag_agreement": agree,
                                   "tagged_reads": tagged}}
    if agree < 0.9:
        raise AssertionError(f"tagFromPhasedVcf agreement {agree:.4f}")

    rregion = mid_region(polish_ds, 10_000)
    t0 = time.perf_counter()
    run_cli(["runLengthMatrix", polish_ds.bam, polish_ds.draft,
             polish_ds.params, "-r", rregion, "-o", f"{work}/rlm"], log_path)
    secs = time.perf_counter() - t0
    m = np.loadtxt(f"{work}/rlm.run_lengths.A.tsv", skiprows=1)[:, 1:]
    diag = sum(m[i, i] for i in range(min(m.shape)))
    log(f"runLengthMatrix {rregion}: {secs:.1f} s, A matrix {m.shape}, "
        f"{int(m.sum())} runs, {diag / m.sum():.3f} on the diagonal")
    if not m.sum() > 1000 or not diag > 0.5 * m.sum():
        raise AssertionError("runLengthMatrix: too few runs, or off the "
                             "diagonal")
    out["run_length_matrix"] = {"s": secs, "runs": int(m.sum())}

    rng = np.random.default_rng(23)
    from margin_tpu_torch.io import bam as bamio
    with bamio.BamReader(polish_ds.bam) as r:
        names = sorted({rec.name for rec in r})
    want = {n: int(rng.integers(1, 3)) for n in names[::2]}
    with open(f"{work}/ids.tsv", "w") as fh:
        fh.writelines(f"{n}\tH{h}\n" for n, h in want.items())
    t0 = time.perf_counter()
    run_cli(["tagFromIds", polish_ds.bam, f"{work}/ids.tsv", "-o",
             f"{work}/ids"], log_path)
    secs = time.perf_counter() - t0
    import struct
    got = {}
    for name, _, _, blob in bam_records(f"{work}/ids.haplotagged.bam"):
        i = blob.find(b"HPi")
        if i >= 0:
            got[name] = struct.unpack_from("<i", blob, i + 3)[0]
    if got != want:
        raise AssertionError("tagFromIds: HP tags differ from the TSV")
    log(f"tagFromIds: {secs:.1f} s, {len(got)} reads tagged as asked")
    out["tag_from_ids"] = {"s": secs, "tagged": len(got)}

    truth = phased_truth_vcf(phase_ds, f"{work}/truth_phased.vcf")
    from margin_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["calcLocalPhasingCorrectness", "-q", truth,
                       f"{phase_out}.phased.vcf"])
    secs = time.perf_counter() - t0
    rows = [ln.split("\t") for ln in buf.getvalue().splitlines()]
    lpc = {float(r[0]): float(r[-1]) for r in rows[1:]}
    log(f"calcLocalPhasingCorrectness (the phase run against the true "
        f"phasing): {secs:.1f} s, {len(lpc)} length scales, weighted mean "
        f"at decay 0: {lpc.get(0.0)}, at decay 1: {lpc.get(1.0)}")
    if rc not in (0, None) or not all(math.isfinite(v) or math.isnan(v)
                                      for v in lpc.values()) \
            or not 0.5 <= lpc.get(0.0, 0) <= 1.0:
        raise AssertionError(f"calcLocalPhasingCorrectness: rc {rc}, "
                             f"{rows[:2]}")
    out["lpc"] = {"s": secs, "decay0": lpc.get(0.0),
                  "decay1": lpc.get(1.0)}
    return out


# ---------------------------------------------------------------------------
# CRAM and BCF input
# ---------------------------------------------------------------------------

# records a CRAM slice (and container) holds in the files written here:
# htslib closes a slice at 500 bases a record on average, about 300 long
# reads; the reader decodes every container a chunk's window overlaps, so
# smaller slices cut the repeated decoding of the Python codec
CRAM_RECORDS_PER_SLICE = 64


def parse_region(region):
    """(contig, 0-based start, end) of a "contig:start-end" region."""
    contig, span = region.rsplit(":", 1)
    start, end = span.split("-")
    return contig, int(start) - 1, int(end)


def write_region_cram(bam, fasta, region, path):
    """The BAM's records that overlap `region` (every record a run on that
    region reads) written as a CRAM with the port's CramWriter against
    `fasta`; then decoded once with CramReader. Returns (records, write s,
    decode s)."""
    from margin_tpu_torch.io import bam as bamio
    from margin_tpu_torch.io.cram import CramReader, CramWriter
    contig, start, end = parse_region(region)
    t0 = time.perf_counter()
    n = 0
    with bamio.BamReader(bam) as r, CramWriter(
            path, r.header, fasta,
            records_per_slice=CRAM_RECORDS_PER_SLICE) as w:
        for rec in r.fetch(contig, start, end):
            w.write(rec)
            n += 1
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with CramReader(path, fasta) as r:
        decoded = sum(1 for _ in r)
    decode_s = time.perf_counter() - t0
    if decoded != n:
        raise AssertionError(f"{path}: {decoded} records decoded of {n}")
    return n, write_s, decode_s


def bam_payloads(path):
    """Every record's whole BAM payload, in file order."""
    from margin_tpu_torch.io import bam as bamio
    with bamio.BamReader(path) as r:
        return [bytes(rec.raw) for rec in r]


def same_but_info(vcf_path, bcf_run_path):
    """Raise unless the phased VCF of the CRAM + BCF run equals the BAM +
    VCF run's byte for byte but in the INFO column of data lines, which is
    "." in the former: vcf_to_bcf (as margin_tpu's) encodes no INFO.
    Returns the number of data lines whose INFO was dropped."""
    with open(vcf_path) as a, open(bcf_run_path) as b:
        la, lb = a.read().split("\n"), b.read().split("\n")
    if len(la) != len(lb):
        raise AssertionError(f"{bcf_run_path}: {len(lb)} lines, {len(la)} "
                             f"in {vcf_path}")
    dropped = 0
    for x, y in zip(la, lb):
        if x.startswith("#") or not x:
            if x != y:
                raise AssertionError(f"header lines differ: {x!r} {y!r}")
            continue
        fx, fy = x.split("\t"), y.split("\t")
        if fx[:7] + fx[8:] != fy[:7] + fy[8:] or fy[7] != ".":
            raise AssertionError(f"phased VCF lines differ: {x[:120]!r} vs "
                                 f"{y[:120]!r}")
        dropped += fx[7] != "."
    return dropped


def phase_cram(phase_ds, region, polish_ds, polish_args, work, out_dir,
               device="cuda"):
    """margin phase and margin polish from CRAM (and BCF): phase 4's region
    of phase 3's BAM written as a CRAM and phase 3's VCF as a BCF, then
    `python -m margin_tpu_torch phase` on them over that region (cli.main,
    counters zeroed right before and read right after): K1 and K2 launched,
    phaseset.bed byte-identical to phase 4's BAM + VCF run, the phased VCF
    too but for the INFO column vcf_to_bcf drops, the haplotagged BAM's
    records identical (its header gains the @HD line the CRAM writer
    adds). Then phase 7's region polished from a CRAM of its reads through
    the kernels: FASTA and HELEN arrays identical to phase 7's BAM run."""
    from margin_tpu_torch.io import bcf
    log_path = os.path.join(out_dir, "chip_smoke_cram.log")
    cram = f"{work}/region.cram"
    n, write_s, decode_s = write_region_cram(phase_ds.bam, phase_ds.fasta,
                                             region, cram)
    t0 = time.perf_counter()
    with open(phase_ds.vcf) as fh:
        bcf.vcf_to_bcf(fh.read().splitlines(), f"{work}/calls.bcf")
    bcf_s = time.perf_counter() - t0
    log(f"CRAM of {region}: {n} records ({CRAM_RECORDS_PER_SLICE} a slice, "
        f"{os.path.getsize(cram)} bytes) written in {write_s:.1f} s, decoded "
        f"in {decode_s:.1f} s; BCF of the VCF in {bcf_s:.2f} s")
    zero_counters()
    wall = run_cli(["phase", cram, phase_ds.fasta, phase_ds.params,
                    f"{work}/calls.bcf", "-o", f"{work}/cram", "-r", region,
                    "-a", "CRITICAL", "--device", device], log_path)
    launches = read_counters()
    if not (launches["K1"] and launches["K2-fwd"] and launches["K2-bwd"]):
        raise AssertionError(f"phase from CRAM: K1 or K2 did not launch "
                             f"({launches})")
    same_files(f"{work}/cram", f"{work}/kern", ("phaseset.bed",))
    dropped = same_but_info(f"{work}/kern.phased.vcf",
                            f"{work}/cram.phased.vcf")
    recs = bam_payloads(f"{work}/cram.haplotagged.bam")
    if recs != bam_payloads(f"{work}/kern.haplotagged.bam"):
        raise AssertionError("phase from CRAM: haplotagged BAM records "
                             "differ from the BAM run's")
    log(f"phase {region} from CRAM + BCF: {wall:.1f} s, launches "
        f"{launches}; phaseset.bed byte-identical to the BAM + VCF run, the "
        f"phased VCF too but for INFO on {dropped} lines (dropped by "
        f"vcf_to_bcf), {len(recs)} haplotagged records identical")
    out = {"phase": {"region": region, "records": n, "write_s": write_s,
                     "decode_s": decode_s, "bcf_s": bcf_s, "wall_s": wall,
                     "launches": launches, "info_dropped_lines": dropped,
                     "haplotagged_records": len(recs),
                     "records_per_slice": CRAM_RECORDS_PER_SLICE}}

    pregion = polish_args["region"]
    pcram = f"{work}/polish_region.cram"
    n, write_s, decode_s = write_region_cram(polish_ds.bam, polish_ds.draft,
                                             pregion, pcram)
    zero_counters()
    secs = polish_run(out=f"{work}/rc", **dict(polish_args, bam=pcram))
    launches = read_counters()
    same_files(f"{work}/rc", f"{work}/rk", ("fa",))
    groups, rows = same_features(f"{work}/rc", f"{work}/rk")
    log(f"polish {pregion} from CRAM ({n} records, written in {write_s:.1f}"
        f" s, decoded in {decode_s:.1f} s): {secs:.1f} s, launches "
        f"{launches}; FASTA and {groups} HELEN groups ({rows} rows) "
        "identical to the BAM run's")
    out["polish"] = {"region": pregion, "records": n, "write_s": write_s,
                     "decode_s": decode_s, "wall_s": secs,
                     "launches": launches, "helen_groups": groups}
    return out


# ---------------------------------------------------------------------------
# the read-partition HMM's device forward-backward, K6
# ---------------------------------------------------------------------------

FUSED_HMMS = []   # (fwd, rev, ref, phase params, fused HMM) a chunk


@contextlib.contextmanager
def fused_hmm_capture():
    """Keep the inputs and the fused HMM of every native_rp.phase_fused_hmm
    call of a run (the native engine's merge tree and final FB)."""
    from margin_tpu_torch.phase import native_rp
    real = native_rp.phase_fused_hmm

    def capture(fwd, rev, ref, params, device):
        hmm = real(fwd, rev, ref, params, device)
        if hmm is not None:
            FUSED_HMMS.append((list(fwd), list(rev), ref, params, hmm))
        return hmm
    native_rp.phase_fused_hmm = capture
    try:
        yield
    finally:
        native_rp.phase_fused_hmm = real


def rphmm_snapshot(hmm):
    """Every field an FB fills: each column's emission, forward, backward
    and total, each merge column's forward and backward, the HMM's two
    totals."""
    import numpy as np
    out = [(np.array(c.emission), np.array(c.forward), np.array(c.backward),
            np.array(c.total_log_prob)) for c in hmm.columns]
    out += [(np.array(m.forward), np.array(m.backward)) for m in hmm.merges]
    out.append((np.array(hmm.forward_log_prob),
                np.array(hmm.backward_log_prob)))
    return out


def same_snapshot(label, got, want):
    import numpy as np
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} parts, {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"{label}: part {i} differs")


def rphmm_stats(hmm):
    from margin_tpu_torch.phase import rphmm_device
    return {"columns": len(hmm.columns),
            "widest_cells": max(len(c.partitions) for c in hmm.columns),
            "deepest_reads": max(c.depth for c in hmm.columns),
            "work": rphmm_device.work(hmm)}


def k6_work(hmm, include_ancestor):
    """K6's integer operations and bytes on this HMM's data, counted from
    each column's own cells, reads, sites and alleles (the pack's padding
    to the HMM's maxima is the layout's, not the function's). A column of
    C cells, D reads and sites of a alleles: the two sums of each cell and
    allele over the reads, 2 x C x D x sum(a) multiply-adds (4 operations
    each pair); with the ancestor a min-plus of the a x a substitutions a
    haplotype and site (4 x C x a^2 operations), without it 2 x C x a
    mins; the chains an add and a max a cell each way. Bytes, in the
    pack's types, read once: a cell's partition (8) and two merge indices
    (4 each), a column's D x sum(a) profile bytes and three counts, a
    site's offset and allele count, and with the ancestor its a^2
    substitutions and a priors (4 each); written once: a cell's emission,
    forward and backward, and each merge slot's two values (4 each)."""
    ops = nbytes = 0
    for col in hmm.columns:
        C = len(col.partitions)
        alleles = [hmm.ref.sites[s].allele_number
                   for s in range(col.ref_start, col.ref_start + col.length)]
        if col.depth and alleles:
            ops += 4 * C * col.depth * sum(alleles)
            ops += (4 * C * sum(a * a for a in alleles) if include_ancestor
                    else 2 * C * sum(alleles))
        ops += 4 * C
        nbytes += 16 * C + 12 + col.depth * sum(alleles) + 8 * len(alleles)
        if include_ancestor:
            nbytes += 4 * sum(a * a + a for a in alleles)
        nbytes += 12 * C
    nbytes += 8 * sum(m.size() for m in hmm.merges)
    return ops, nbytes


def k6_split(pk, include_ancestor, reps=5, tries=3):
    """Each K6 kernel's device microseconds a launch, k6_emissions and
    k6_chain apart, from torch.profiler over `reps` launches; a session
    that shows no K6 kernel (CUPTI loses one now and then) is tried again,
    up to `tries` times, then both are None (not measured)."""
    from margin_tpu_torch.ops import rphmm_fb
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch_sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                rphmm_fb.rphmm_fb(pk, include_ancestor)
            torch_sync()
        out = {"k6_emissions": 0.0, "k6_chain": 0.0}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            for name in out:
                if name in ev.key:
                    out[name] += t / reps
        if out["k6_emissions"] and out["k6_chain"]:
            return out
    log("torch.profiler showed no K6 kernel in "
        f"{tries} sessions: its kernels' times are not measured here")
    return {"k6_emissions": None, "k6_chain": None}


def k6_pack_row(pk, include_ancestor, stats, work, label, reps=5):
    """K6 against its twin on one pack (every output equal: tolerance 0),
    then K6's time (the two launches, CUDA events), its kernels' device
    times apart (torch.profiler; ns a column of the chain, each sweep),
    the twin's time, and the bound from `work` = k6_work of the HMM the
    pack was made from. Returns (the row, the twin's outputs)."""
    import torch
    from margin_tpu_torch.ops import rphmm_fb
    got = rphmm_fb.rphmm_fb(pk, include_ancestor)
    torch_sync()
    t0 = time.perf_counter()
    want = rphmm_fb.rphmm_fb_plain(pk, include_ancestor)
    torch_sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((g.long() - w.long()).abs().max()) for g, w in
              zip(got, want))
    if err:
        raise AssertionError(f"K6 against its twin, {label}: max|diff| "
                             f"{err}, tolerance 0")
    ms = cuda_ms(lambda: rphmm_fb.rphmm_fb(pk, include_ancestor), reps=reps)
    split = k6_split(pk, include_ancestor, reps)
    bms, by = bound_ms(*work)
    ncol, C, D, A, S, As, M = pk.dims
    lay = rphmm_fb.k6_launch(C, A, D, As, S, M, include_ancestor)
    row = dict(stats, shape=label, include_ancestor=include_ancestor,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, ns_per_column=ms * 1e6 / stats["columns"],
               emissions_us=split["k6_emissions"],
               chain_us=split["k6_chain"],
               chain_ns_per_column=(None if split["k6_chain"] is None
                                    else split["k6_chain"] * 1e3 / ncol),
               layout=lay._asdict())
    return row, want


def k6_log(label, row):
    if row["chain_us"] is None:
        split = "kernels apart not measured"
    else:
        split = (f"k6_emissions {row['emissions_us']:.1f} us, k6_chain "
                 f"{row['chain_us']:.1f} us, {row['chain_ns_per_column']:.0f}"
                 " ns a column, the two sweeps side by side")
    log(f"K6 {label}: kernel {row['ms']:.3f} ms ({split}), twin "
        f"{row['plain_ms']:.1f} ms, bound {row['bound_ms']:.3g} ms "
        f"({row['bound_by']}); sums in {row['layout']['sums']}, carry in "
        f"{row['layout']['carry']} memory; identical to the twin")


def k6_against(hmm, include_ancestor, label, device="cuda", reps=5):
    """One HMM's FB through K6 (forward_backward_device), its plain twin
    and the host float64 path: identical fields; then k6_pack_row's times
    and bound, the host FB's time, the pack's (first call on this HMM,
    then the median of 3) and K6 end to end (pack, launches, one read
    back)."""
    from margin_tpu_torch.phase import rphmm_device
    torch_sync()
    t0 = time.perf_counter()
    pk = rphmm_device.pack(hmm, device)
    torch_sync()
    pack_first_ms = (time.perf_counter() - t0) * 1e3
    os.environ["MARGIN_TPU_RPHMM"] = "host"
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        hmm.forward_backward(include_ancestor=include_ancestor)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    host = rphmm_snapshot(hmm)
    e2e_ms, pack_ms = [], []
    for _ in range(3):
        torch_sync()
        t0 = time.perf_counter()
        rphmm_device.pack(hmm, device)
        torch_sync()
        t1 = time.perf_counter()
        rphmm_device.forward_backward_device(hmm, include_ancestor, device)
        e2e_ms.append((time.perf_counter() - t1) * 1e3)
        pack_ms.append((t1 - t0) * 1e3)
    same_snapshot(f"K6 against the host FB, {label}", rphmm_snapshot(hmm),
                  host)
    st = rphmm_stats(hmm)
    row, want = k6_pack_row(pk, include_ancestor, st,
                            k6_work(hmm, include_ancestor), label, reps)
    rphmm_device.fill(hmm, *(w.cpu().numpy() for w in want))
    same_snapshot(f"K6's twin against the host FB, {label}",
                  rphmm_snapshot(hmm), host)
    row.update(host_ms=statistics.median(host_ms),
               e2e_ms=statistics.median(e2e_ms),
               pack_ms=statistics.median(pack_ms),
               pack_first_ms=pack_first_ms)
    log(f"K6 {label} ({st['columns']} columns, widest {st['widest_cells']} "
        f"cells, deepest {st['deepest_reads']} reads, work {st['work']}, "
        f"ancestor {include_ancestor}): host float64 FB "
        f"{row['host_ms']:.1f} ms, K6 with pack and read back "
        f"{row['e2e_ms']:.1f} ms, the pack {row['pack_ms']:.1f} ms (first "
        f"call {pack_first_ms:.1f} ms); identical to the host FB")
    k6_log(label, row)
    return row


def fragment_key(gf):
    return (gf.ref_start, gf.length, gf.haplotype_string1.tolist(),
            gf.haplotype_string2.tolist(), gf.genotype_string.tolist(),
            gf.genotype_probs.tolist(), sorted(gf.reads1), sorted(gf.reads2))


def random_profile_seqs(seed, n_sites, n_reads, span):
    """A seeded reference of n_sites sites (2-3 alleles, random priors and
    substitutions) and n_reads profile sequences of span[0]..span[1] sites
    with random allele probabilities, as in tests/test_rphmm_device.py."""
    import numpy as np
    from margin_tpu_torch.phase import bubbles
    rng = np.random.default_rng(seed)
    sites, off = [], 0
    for _ in range(n_sites):
        a = int(rng.integers(2, 4))
        sites.append(bubbles.Site(
            a, off, rng.integers(0, 30, a).astype(np.uint16),
            rng.integers(0, 90, (a, a)).astype(np.uint16)))
        off += a
    ref = bubbles.Reference("random", sites, off)
    offsets = ref.allele_offsets()
    seqs = []
    for i in range(n_reads):
        n = int(rng.integers(span[0], span[1]))
        s = int(rng.integers(0, n_sites - n))
        probs = rng.integers(0, 64, int(offsets[s + n] - offsets[s]))
        seqs.append(bubbles.ProfileSeq(None, f"r{i}", s, n, int(offsets[s]),
                                       probs.astype(np.uint8)))
    return ref, seqs


def wide_site_pack(device, seed=41, ncol=6, C=256, wide=300, M=150):
    """A seeded pack of ncol columns of 64 reads over three sites of 2,
    `wide` and 3 alleles, random partitions and merge maps: a site whose
    ancestor allele sums (2 x `wide` ints a thread) go beyond K6's register
    bucket: to shared memory at 64 threads a block for 300 alleles, to
    device memory for 800."""
    import numpy as np
    import torch
    from margin_tpu_torch.ops import rphmm_fb
    rng = np.random.default_rng(seed)
    site_a = np.tile(np.array([2, wide, 3], np.int32), (ncol, 1))
    site_off = (np.cumsum(site_a, axis=1) - site_a).astype(np.int32)
    A, As = int(site_a[0].sum()), wide
    sub = rng.integers(0, 90, (ncol, 3, As, As)).astype(np.int32)
    prior = rng.integers(0, 30, (ncol, 3, As)).astype(np.int32)
    j = np.arange(As)
    for s, a in enumerate(site_a[0]):
        sub[:, s, j >= a, :] = rphmm_fb.BIG
        sub[:, s, :, j >= a] = rphmm_fb.BIG
        prior[:, s, j >= a] = 0
    arrays = (
        rng.integers(-(1 << 62), 1 << 62, (ncol, C), dtype=np.int64),
        rng.integers(C // 2, C + 1, ncol).astype(np.int32),
        np.full(ncol, 64, dtype=np.int32), np.full(ncol, 3, dtype=np.int32),
        rng.integers(0, 64, (ncol, A, 64)).astype(np.uint8),
        site_off, site_a, sub, prior,
        rng.integers(0, M, (ncol, C)).astype(np.int32),
        rng.integers(0, M, (ncol, C)).astype(np.int32))
    return rphmm_fb.RphmmPack(*(torch.from_numpy(a).to(device)
                                for a in arrays), M)


def k6_pack_work(pk, include_ancestor):
    """k6_work's counts for a seeded pack with no HMM behind it, from each
    column's own cells, reads, sites and alleles."""
    ops = nbytes = 0
    for n, d, sa in zip(pk.n_cells.tolist(), pk.depth.tolist(),
                        pk.site_a.tolist()):
        alleles = [a for a in sa if a]
        ops += 4 * n * d * sum(alleles) + 4 * n
        ops += (4 * n * sum(a * a for a in alleles) if include_ancestor
                else 2 * n * sum(alleles))
        nbytes += 28 * n + 12 + d * sum(alleles) + 8 * len(alleles)
        if include_ancestor:
            nbytes += 4 * sum(a * a + a for a in alleles)
    return ops, nbytes + 8 * pk.parts.shape[0] * pk.M


def k6_wide_site(device="cuda"):
    """K6 against its twin on a site of 300 alleles with the ancestor (its
    allele sums in shared memory, 64 threads a block) and on one of 800
    (beyond shared memory: in device memory): every output equal. Returns
    the two rows."""
    rows = []
    for wide, place in ((300, "shared"), (800, "device")):
        pk = wide_site_pack(device, wide=wide)
        ncol, C, D, A, S, As, M = pk.dims
        row, _ = k6_pack_row(pk, True, {"columns": ncol, "widest_cells": C,
                                        "deepest_reads": D, "work": None},
                             k6_pack_work(pk, True),
                             f"{ncol} columns x {C} cells, a {As}-allele "
                             "site")
        if row["layout"]["sums"] != place:
            raise AssertionError(f"K6 kept {As}-allele sums in "
                                 f"{row['layout']['sums']} memory, not "
                                 f"{place}")
        k6_log(f"on a {As}-allele site with the ancestor ({ncol} columns x "
               f"{C} cells, {D} reads)", row)
        rows.append(row)
    return rows


def random_pack(device, seed=43, ncol=6, C=3000, n_sites=4, M=20_000,
                full_range=True):
    """A seeded K6 pack of ncol columns of 64 reads over n_sites sites of
    2-3 alleles each, random merge maps into M slots; partitions over all
    64 bits with full_range (bit 63 set on about half), else below 2**62 in
    magnitude. The defaults: merge rows that do not fit K6's shared carry.
    The tests and scripts/k6_compare.py build their packs here too."""
    import numpy as np
    import torch
    from margin_tpu_torch.ops import rphmm_fb
    rng = np.random.default_rng(seed)
    top = 1 << 63 if full_range else 1 << 62
    site_a = rng.integers(2, 4, (ncol, n_sites)).astype(np.int32)
    site_off = (np.cumsum(site_a, axis=1) - site_a).astype(np.int32)
    A = int(site_a.sum(axis=1).max())
    sub = rng.integers(0, 90, (ncol, n_sites, 3, 3)).astype(np.int32)
    prior = rng.integers(0, 30, (ncol, n_sites, 3)).astype(np.int32)
    two = site_a == 2
    sub[two, 2, :] = rphmm_fb.BIG
    sub[two, :, 2] = rphmm_fb.BIG
    prior[two, 2] = 0
    arrays = (
        rng.integers(-top, top - 1, (ncol, C), dtype=np.int64),
        rng.integers(C // 2, C + 1, ncol).astype(np.int32),
        np.full(ncol, 64, dtype=np.int32),
        np.full(ncol, n_sites, dtype=np.int32),
        rng.integers(0, 64, (ncol, A, 64)).astype(np.uint8),
        site_off, site_a, sub, prior,
        rng.integers(0, M, (ncol, C)).astype(np.int32),
        rng.integers(0, M, (ncol, C)).astype(np.int32))
    return rphmm_fb.RphmmPack(*(torch.from_numpy(a).to(device)
                                for a in arrays), M)


def k6_wide_merge(device="cuda"):
    """K6 on merge rows of 20,000 slots (its carry in device memory), with
    and without the ancestor, against its twin: every output equal."""
    pk = random_pack(device)
    ncol, C, D, A, S, As, M = pk.dims
    rows = []
    for anc in (False, True):
        row, _ = k6_pack_row(pk, anc, {"columns": ncol, "widest_cells": C,
                                       "deepest_reads": D, "work": None},
                             k6_pack_work(pk, anc),
                             f"{ncol} columns x {C} cells, {M} merge slots")
        if row["layout"]["carry"] != "device":
            raise AssertionError(f"K6 kept {M} merge slots in shared memory")
        k6_log(f"on {M} merge slots ({ncol} columns x {C} cells, ancestor "
               f"{anc})", row)
        rows.append(row)
    return rows


def k6_merge_tree(fwd, rev, ref, params, device="cuda"):
    """margin_tpu's path without the native engine on two read sets,
    through the port's entry points: get_rp_hmms -> merge_two_tiling_paths
    -> fuse_tiling_path -> forward_backward. A capture pass times each FB
    on the host, through K6 (pack and read-back included) and its pack
    alone, and keeps the largest FB's pack, on which K6 is held against its
    twin and timed; then the tree is timed bare with
    MARGIN_TPU_RPHMM=device (the K6 counter zeroed right before and read
    right after) and =host, three turns each: the same traceback and genome
    fragment every time."""
    from margin_tpu_torch.ops import rphmm_fb
    from margin_tpu_torch.phase import rphmm, rphmm_device
    from margin_tpu_torch.phase.fragment import construct_genome_fragment
    real_fbd = rphmm_device.forward_backward_device
    largest, per_fb = {}, []

    def record(hmm, include_ancestor, dev):
        # each FB on the host, then through K6 with its pack and read-back
        # (the one the tree goes on with), each timed, then its pack alone;
        # the largest kept
        w = rphmm_device.work(hmm)
        os.environ["MARGIN_TPU_RPHMM"] = "host"
        t0 = time.perf_counter()
        hmm.forward_backward(include_ancestor=include_ancestor)
        t1 = time.perf_counter()
        os.environ["MARGIN_TPU_RPHMM"] = "device"
        real_fbd(hmm, include_ancestor, dev)
        torch_sync()
        t2 = time.perf_counter()
        pk = rphmm_device.pack(hmm, dev)
        torch_sync()
        per_fb.append((w, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                       (time.perf_counter() - t2) * 1e3))
        if w > largest.get("work", -1):
            largest.update(work=w, pk=pk,
                           include_ancestor=include_ancestor,
                           stats=rphmm_stats(hmm),
                           bound=k6_work(hmm, include_ancestor))

    def tree(mode):
        os.environ["MARGIN_TPU_RPHMM"] = mode
        t0 = time.perf_counter()
        tp_f = rphmm.get_rp_hmms(fwd, ref, params, device)
        tp_r = rphmm.get_rp_hmms(rev, ref, params, device)
        merged = rphmm.merge_two_tiling_paths(tp_f, tp_r,
                                              include_ancestor=False)
        hmm = rphmm.fuse_tiling_path(merged)
        hmm.forward_backward(include_ancestor=True)
        path = hmm.forward_traceback()
        gf = construct_genome_fragment(hmm, path)
        torch_sync()
        return path, fragment_key(gf), time.perf_counter() - t0

    rphmm_device.forward_backward_device = record
    try:
        tree("device")
    finally:
        rphmm_device.forward_backward_device = real_fbd
    dev_s, host_s, launches, outs = [], [], [], []
    for _ in range(3):
        rphmm_fb.RPHMM_FB.launches = 0
        path, gf, secs = tree("device")
        launches.append(rphmm_fb.RPHMM_FB.launches)
        dev_s.append(secs)
        outs.append((path, gf))
        path, gf, secs = tree("host")
        host_s.append(secs)
        outs.append((path, gf))
    if min(launches) == 0:
        raise AssertionError("the merge tree under MARGIN_TPU_RPHMM=device "
                             "launched no K6")
    if any(o != outs[0] for o in outs):
        raise AssertionError("the merge tree on K6 gave another traceback "
                             "or genome fragment than on the host")
    log(f"merge tree of {len(fwd)} + {len(rev)} reads on {ref.length} "
        f"sites, three turns: MARGIN_TPU_RPHMM=device "
        f"{[round(x, 3) for x in dev_s]} s, {launches[0]} K6 launches "
        f"each; host {[round(x, 3) for x in host_s]} s; same traceback "
        f"({len(outs[0][0])} columns) and genome fragment")
    wins = [f for f in per_fb if f[2] < f[1]]
    pack_ms = sum(f[3] for f in per_fb)
    log(f"the merge tree's {len(per_fb)} FBs (work {min(per_fb)[0]}-"
        f"{max(per_fb)[0]}): K6 with pack and read-back faster than the "
        f"host float64 FB on {len(wins)}; the packs {pack_ms:.1f} ms in "
        "all; (work, host ms, K6 with pack ms, pack ms): "
        f"{[tuple(round(x, 3) for x in f) for f in sorted(per_fb)]}")
    st = largest["stats"]
    label = (f"the merge tree's largest FB, {st['columns']} columns x "
             f"{st['widest_cells']} cells")
    row, _ = k6_pack_row(largest["pk"], largest["include_ancestor"], st,
                         largest["bound"], label)
    k6_log(f"on {label} ({st})", row)
    tree_info = {"reads": [len(fwd), len(rev)], "sites": ref.length,
                 "device_s": statistics.median(dev_s),
                 "host_s": statistics.median(host_s), "device_runs_s": dev_s,
                 "host_runs_s": host_s, "launches": launches[0],
                 "per_fb": per_fb}
    return row, tree_info


def k6_cross_product(big, device="cuda"):
    """The cross product of two seeded random read sets' tiling paths (as
    merge_two_tiling_paths FBs it) of most work, which must reach the auto
    threshold 10,000,000; MARGIN_TPU_RPHMM=auto must send its FB to K6 by
    itself (one launch)."""
    from margin_tpu_torch.ops import rphmm_fb
    from margin_tpu_torch.params import PhaseParams
    from margin_tpu_torch.phase import rphmm, rphmm_device
    seed, n_sites, n_reads, span = big
    bref, seqs = random_profile_seqs(seed, n_sites, n_reads, span)
    bparams = PhaseParams()
    os.environ["MARGIN_TPU_RPHMM"] = "host"
    t0 = time.perf_counter()
    tp1 = rphmm.get_rp_hmms(seqs[0::2], bref, bparams, device)
    tp2 = rphmm.get_rp_hmms(seqs[1::2], bref, bparams, device)
    crosses = []
    for comp in rphmm.get_overlapping_components(tp1, tp2):
        sub = rphmm.get_tiling_paths(comp)
        if len(sub) == 2:
            h1 = rphmm.fuse_tiling_path(sub[0])
            h2 = rphmm.fuse_tiling_path(sub[1])
            rphmm.RPHmm.align_columns(h1, h2)
            crosses.append(rphmm.RPHmm.cross_product(h1, h2))
    hmm = max(crosses, key=rphmm_device.work)
    build_s = time.perf_counter() - t0
    w = rphmm_device.work(hmm)
    if w < 10_000_000:
        raise AssertionError(f"the random cross product's work {w} is "
                             "below the auto threshold")
    os.environ.pop("MARGIN_TPU_RPHMM", None)
    os.environ.pop("MARGIN_TPU_RPHMM_THRESHOLD", None)
    n0 = rphmm_fb.RPHMM_FB.launches
    hmm.forward_backward(include_ancestor=False)
    if rphmm_fb.RPHMM_FB.launches != n0 + 1:
        raise AssertionError("MARGIN_TPU_RPHMM=auto did not send the HMM "
                             f"of work {w} to K6")
    log(f"random cross product ({n_reads} reads on {n_sites} sites, built "
        f"in {build_s:.1f} s): work {w}; MARGIN_TPU_RPHMM=auto sent its FB "
        "to K6")
    return k6_against(hmm, False, "a random cross product of work >= 10M",
                      device)


@contextlib.contextmanager
def rphmm_env():
    """MARGIN_TPU_RPHMM and its threshold as they were, after a phase that
    sets them."""
    saved = {k: os.environ.get(k) for k in ("MARGIN_TPU_RPHMM",
                                            "MARGIN_TPU_RPHMM_THRESHOLD")}
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_rphmm(device="cuda", big=(31, 600, 220, (60, 150))):
    """The stRPHmm FB on K6. (1) k6_merge_tree on the profile sequences of
    phase 4's region chunk with the most reads: its bare run under
    MARGIN_TPU_RPHMM=device is the main path's, with the K6 counter zeroed
    right before and read right after. (2) Every fused HMM the native
    engine returned for phase 4's chunks, FB'd again through K6, its twin
    and the host float64 path: identical fields; timed on the one of most
    work. (3) k6_cross_product, held and timed the same way. (4) K6 on
    sites of 300 and 800 alleles and on merge rows of 20,000 slots, against
    its twin."""
    from margin_tpu_torch.ops import rphmm_fb
    from margin_tpu_torch.phase import rphmm_device
    if not FUSED_HMMS:
        raise AssertionError("phase 4's region run gave no fused HMM")
    out = {}
    with rphmm_env():
        fwd, rev, ref, params, _ = max(FUSED_HMMS,
                                       key=lambda f: len(f[0]) + len(f[1]))
        out["main_path"], out["merge_tree"] = k6_merge_tree(
            fwd, rev, ref, params, device)
        out["launches"] = {"K6": out["merge_tree"]["launches"]}

        # the fused HMMs of phase 4's chunks
        stats = []
        for i, (_, _, _, _, hmm) in enumerate(FUSED_HMMS):
            os.environ["MARGIN_TPU_RPHMM"] = "host"
            hmm.forward_backward(include_ancestor=True)
            host = rphmm_snapshot(hmm)
            rphmm_device.forward_backward_device(hmm, True, device)
            same_snapshot(f"K6, fused HMM {i}", rphmm_snapshot(hmm), host)
            pk = rphmm_device.pack(hmm, device)
            twin = rphmm_fb.rphmm_fb_plain(pk, True)
            rphmm_device.fill(hmm, *(t.cpu().numpy() for t in twin))
            same_snapshot(f"K6's twin, fused HMM {i}", rphmm_snapshot(hmm),
                          host)
            stats.append(rphmm_stats(hmm))
        log(f"{len(FUSED_HMMS)} fused HMMs of phase 4's chunks (columns, "
            f"widest column's cells, deepest column's reads, work): "
            f"{[tuple(s.values()) for s in stats]}; K6, its twin and the "
            "host FB identical on each")
        top = max(range(len(stats)), key=lambda i: stats[i]["work"])
        out["fused"] = {"hmms": stats, "largest": k6_against(
            FUSED_HMMS[top][4], True, "the largest fused HMM", device)}
        out["threshold"] = k6_cross_product(big, device)
        out["wide_site"] = k6_wide_site(device)
        out["wide_merge"] = k6_wide_merge(device)
    return out


def phase_k6(device="cuda", big=(31, 600, 220, (60, 150)),
             tree=(5, 24, 44, (10, 23))):
    """K6's loop, needing no phase: k6_cross_product, the 300- and
    800-allele sites, merge rows of 20,000 slots, and k6_merge_tree on the
    two halves of a seeded random read set (random_profile_seqs(*tree));
    each held against the twin (and the host FB where an HMM is behind it)
    and timed."""
    from margin_tpu_torch import _ext
    from margin_tpu_torch.params import PhaseParams
    log(f"k6: rphmm_fb built in "
        f"{_ext.BUILD_SECONDS.get('rphmm_fb', 0.0):.1f} s")
    out = {}
    with rphmm_env():
        out["threshold"] = k6_cross_product(big, device)
        out["wide_site"] = k6_wide_site(device)
        out["wide_merge"] = k6_wide_merge(device)
        ref, seqs = random_profile_seqs(*tree)
        out["main_path"], out["merge_tree"] = k6_merge_tree(
            seqs[0::2], seqs[1::2], ref, PhaseParams(), device)
    return out


SOURCES = {
    "K1": ("margin_tpu_torch/csrc/pairhmm_forward.cu",
           "margin_tpu/ops/pairhmm.py:194"),
    "K2-fwd": ("margin_tpu_torch/csrc/banded_fb.cu",
               "margin_tpu/ops/pallas_banded.py:174"),
    "K2-bwd": ("margin_tpu_torch/csrc/banded_fb.cu",
               "margin_tpu/ops/pallas_banded.py:253"),
    "K2-bwd WORDS": ("margin_tpu_torch/csrc/banded_fb.cu",
                     "margin_tpu/ops/banded.py:704"),
    "K3-fwd": ("margin_tpu_torch/csrc/banded_seg.cu",
               "margin_tpu/ops/pallas_banded.py:873"),
    "K3-bwd": ("margin_tpu_torch/csrc/banded_seg.cu",
               "margin_tpu/ops/pallas_banded.py:964"),
    "K4": ("margin_tpu_torch/csrc/banded_fb.cu",
           "margin_tpu/ops/banded.py:267"),
    "K5-fwd": ("margin_tpu_torch/csrc/banded_wide.cu",
               "margin_tpu/ops/banded.py:267"),
    "K5-exp": ("margin_tpu_torch/csrc/banded_wide.cu",
               "margin_tpu/ops/banded.py:267"),
    "K6": ("margin_tpu_torch/csrc/rphmm_fb.cu",
           "margin_tpu/phase/rphmm_device.py:80"),
}


PHASES = ("kernels", "phase", "polish", "diploid", "em", "helen", "tools",
          "cram", "rphmm")
CHOICES = PHASES + ("k1", "k5", "k6")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated subset of %s to run after the "
                         "build, for iterating on one path (k1: K1's "
                         "shapes of the kernels phase alone; k5: both K5 "
                         "designs on their loop's packs; k6: K6 on its "
                         "loop's HMMs and packs; tools and "
                         "rphmm need phase, cram needs phase and polish); "
                         "the kernels line is printed only when all of %s "
                         "run" % (CHOICES, PHASES))
    ap.add_argument("--twin-job", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(CHOICES):
        ap.error(f"--only takes names from {CHOICES}")
    for name, needs in (("tools", {"phase"}), ("rphmm", {"phase"}),
                        ("cram", {"phase", "polish"})):
        if name in only and not needs <= only:
            ap.error(f"{name} needs {', '.join(sorted(needs))}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the GPU port only",
              file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(ROOT, "margin_tpu_torch",
                                       "__init__.py")):
        print("chip_smoke: run from a checkout of the repository (no "
              "margin_tpu_torch package beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.twin_job is not None:   # a twin run of run_twin_jobs
        twin_job(json.loads(args.twin_job))
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    card = card_line()
    log(f"card: {card}")
    try:
        import h5py  # noqa: F401
        log("h5py: present (HELEN arrays are still held in memory here)")
    except ImportError:
        log("h5py: absent (-f would stop naming it; the HELEN phases hold "
            "the arrays the HDF5 file would get)")
    t_start = time.perf_counter()
    report = {"card": card, "device": torch.cuda.get_device_name(0),
              "phase_s": {}}
    t_lap = [t_start]

    def lap(name):
        """Log and keep the seconds since the previous lap."""
        now = time.perf_counter()
        report["phase_s"][name] = secs = now - t_lap[0]
        t_lap[0] = now
        log(f"... phase {name}: {secs:.1f} s")
    report["build"] = phase_build()
    lap("build")
    if "kernels" in only or "k1" in only:
        report["k1"] = phase_k1("cuda")
        lap("k1")
    if "k5" in only:
        report["k5"] = phase_k5("cuda")
        lap("k5")
    if "k6" in only:
        report["k6"] = phase_k6("cuda")
        lap("k6")
    if "kernels" in only:
        report["k2"] = phase_k2("cuda")
        report["k3"] = phase_k3("cuda")
        report["k3_deep"] = phase_k3_deep("cuda")
        lap("kernels")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if "phase" in only:
            report["phase"], rec, phase_ds = phase_e2e("cuda", work, out_dir)
            report["main_path_shapes"] = phase_main_path_shapes(rec)
            lap("phase")
        ds = None
        if "polish" in only:
            report["polish"], ds, prec = phase_polish("cuda", work, out_dir)
            report["polish"]["words_check"] = words_on_largest(
                prec, "the polish run's largest K2 pack", timed=True)
            report["polish_region"] = phase_polish_region(ds, work)
            report.setdefault("main_path_shapes", {}).update(
                phase_k3_main_path(prec))
            lap("polish")
        if "diploid" in only:
            report["diploid"], dds = phase_diploid("cuda", work, out_dir)
            report["diploid_region"] = phase_diploid_region(dds, work)
            lap("diploid")
        if ds is None and only & {"em", "helen", "tools"}:
            ds = polish_dataset(work)
        if "em" in only:
            report["em"] = phase_em(ds)
            lap("em")
        if "helen" in only:
            report["helen"] = phase_helen(ds, work)
            lap("helen")
        if "tools" in only:
            report["tools"] = phase_tools(phase_ds, f"{work}/full",
                                          report["phase"]["region"], ds,
                                          work, out_dir)
            lap("tools")
        if "cram" in only:
            report["cram"] = phase_cram(phase_ds, report["phase"]["region"],
                                        ds, report["polish_region"]["args"],
                                        work, out_dir)
            lap("cram")
        if "rphmm" in only:
            report["rphmm"] = phase_rphmm()
            lap("rphmm")
        report["twins"] = run_twin_jobs(work)
        lap("twins")
        if "phase" in only and "polish" in only:
            summed = {k: report["phase"]["kernel_ms"][k]
                      + report["polish"]["kernel_ms"][k]
                      for k in report["polish"]["kernel_ms"]
                      if k not in ("K4", "K5-fwd", "K5-exp")}
            report["main_path_device_ms"] = summed
            log("device ms summed over the phase and polish runs' launches "
                "(extraction: extract_packed's torch ops, none on this "
                f"route): { {k: round(v, 1) for k, v in summed.items()} }")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    if K1_LAUNCH_LOG:
        with open(os.path.join(out_dir, "k1_launches.json"), "w") as fh:
            json.dump(K1_LAUNCH_LOG, fh)
    log(f"total {report['total_s']:.1f} s")
    print(card)
    if only >= set(PHASES):
        kernels = []
        for name, (src, rep) in SOURCES.items():
            if name == "K4":   # K4's path is EM's
                m, path = report["em"]["k4"][0], "em"
            elif name.startswith("K5"):   # EM on kmer anchors
                m = report["em"]["k5"][name]
                launches = report["em"]["kmer"]["launches"][name]
            elif name == "K6":   # the merge tree's FBs
                m, path = report["rphmm"]["main_path"], "rphmm"
            else:
                m = report["main_path_shapes"][name]
                path = "polish" if name.startswith("K3") else "phase"
            if not name.startswith("K5"):
                launches = report[path]["launches"][name]
            kernels.append({"name": name, "route": "cuda", "source": src,
                            "replaces": rep, "launches": launches,
                            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                            "plain_ms": m["plain_ms"],
                            "bound_ms": m["bound_ms"],
                            "bound_by": m["bound_by"], "library_ms": None})
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
