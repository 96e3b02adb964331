"""Seeded synthetic dataset for `margin phase`: numpy only, nothing read
from outside the repository.

`write_dataset(out_dir, SynthConfig(...))` writes:
  * ref.fa          a random reference contig;
  * calls.vcf       het SNVs and het SVs (insertions and deletions) as
                    unphased 0/1 calls, PASS;
  * reads.bam(.bai) ONT-like reads drawn from the two haplotypes on both
                    strands, with substitution, insertion and deletion
                    errors and their true alignments to the reference;
                    read names carry the source haplotype ("..._h1");
  * params.json     the default nucleotide HMM
                    (StateMachineParams.default_nucleotide) in the
                    `from_hmm_json` format, with SV handling on
                    (phase.indelSizeForSVHandling).
and returns the paths with the truth (het sites, read origins).
"""

from __future__ import annotations

import json
import math
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from margin_tpu_torch.io import bam as bamio
from margin_tpu_torch.io.fasta import write_fasta
from margin_tpu_torch.params import StateMachineParams

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_NT16 = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _NT16[_c] = _i
M, I, D, S = 0, 1, 2, 4  # BAM cigar ops


@dataclass
class SynthConfig:
    contig: str = "chr1"
    contig_len: int = 20_000
    coverage: float = 12.0
    read_len: Tuple[int, int] = (2000, 6000)
    n_snv: int = 15
    n_sv: int = 2
    sv_len: Tuple[int, int] = (100, 300)
    sv_short_fraction: float = 1.0   # share of SVs below sv_short_max
    sv_short_max: int = 500
    sv_min_gap: int = 5000           # between SVs, and from the ends
    p_sub: float = 0.03
    p_ins: float = 0.02
    p_del: float = 0.03
    sv_handling: int = 50            # phase.indelSizeForSVHandling
    sv_expansion: int = 1024         # referenceExpansionForStructuralVariants
    seed: int = 0


@dataclass
class Variant:
    pos: int          # 0-based reference position of the first REF base
    ref: str
    alt: str
    hap: int          # haplotype (1 or 2) carrying ALT
    kind: str         # "snv", "ins" or "del"


@dataclass
class SynthDataset:
    bam: str
    fasta: str
    vcf: str
    params: str
    contig: str
    variants: List[Variant] = field(default_factory=list)
    read_hap: Dict[str, int] = field(default_factory=dict)


def hmm_json(sm: StateMachineParams) -> dict:
    """The asymmetric (type 3) trained-HMM JSON whose `from_hmm_json`
    load gives back `sm` (params.py:101-128)."""
    e = math.exp
    trans = [[e(sm.t_match_continue), e(sm.t_gap_open_x), e(sm.t_gap_open_y)],
             [e(sm.t_match_from_gap_x), e(sm.t_gap_extend_x),
              e(sm.t_gap_switch_to_y)],
             [e(sm.t_match_from_gap_y), e(sm.t_gap_switch_to_x),
              e(sm.t_gap_extend_y)]]
    emissions = (np.exp(sm.match_probs[:4, :4]).ravel().tolist()
                 + np.exp(sm.gap_x_probs[:4]).tolist()
                 + np.exp(sm.gap_y_probs[:4]).tolist())
    return {"type": 3, "emissionsType": 0,
            "transitions": [v for row in trans for v in row],
            "emissions": emissions}


def build_bam_record(name: str, flag: int, ref_id: int, pos: int, mapq: int,
                     cigar: List[Tuple[int, int]], seq: bytes,
                     quals: Optional[bytes], tags: bytes = b"",
                     mate_ref_id: int = -1, mate_pos: int = -1,
                     tlen: int = 0) -> bytes:
    """A BAM-format record payload (copy of margin_tpu/io/cram.py:565,
    returning the raw bytes; the 4-bit sequence packing is vectorised)."""
    name_b = name.encode() + b"\x00"
    cigar_b = b"".join(struct.pack("<I", (ln << 4) | op) for op, ln in cigar)
    codes = _NT16[np.frombuffer(seq, dtype=np.uint8)]
    if len(codes) % 2:
        codes = np.append(codes, 0)
    seq_b = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
    qual_b = quals if quals is not None else b"\xff" * len(seq)
    return struct.pack("<iiBBHHHiiii", ref_id, pos, len(name_b), mapq, 0,
                       len(cigar), flag, len(seq), mate_ref_id, mate_pos,
                       tlen) + name_b + cigar_b + seq_b + qual_b + tags


def _place_variants(rng, cfg: SynthConfig, ref: np.ndarray) -> List[Variant]:
    L = cfg.contig_len
    taken = np.zeros(L, dtype=bool)
    out: List[Variant] = []
    # SVs: evenly spread slots, jittered, at least sv_min_gap apart
    n_sv = cfg.n_sv
    if n_sv:
        span = L - 2 * cfg.sv_min_gap
        if span < 0 or (n_sv > 1 and span / (n_sv - 1) < cfg.sv_min_gap):
            raise ValueError("contig too short for the SVs asked for")
        slots = (np.linspace(cfg.sv_min_gap, L - cfg.sv_min_gap, n_sv)
                 if n_sv > 1 else np.array([L / 2]))
        jitter = max(0, int((span / max(n_sv - 1, 1) - cfg.sv_min_gap) / 2))
        n_short = int(round(cfg.sv_short_fraction * n_sv))
        for j, c in enumerate(slots):
            p = int(c) + (int(rng.integers(-jitter, jitter + 1))
                          if jitter else 0)
            lo, hi = cfg.sv_len
            if j < n_short:
                ln = int(rng.integers(lo, min(hi, cfg.sv_short_max) + 1))
            else:
                ln = int(rng.integers(max(lo, cfg.sv_short_max), hi + 1))
            hap = int(rng.integers(1, 3))
            r0 = chr(ref[p])
            if rng.random() < 0.5:
                ins = _BASES[rng.integers(0, 4, ln)].tobytes().decode()
                out.append(Variant(p, r0, r0 + ins, hap, "ins"))
                taken[max(0, p - 300):p + 300] = True
            else:
                seq = ref[p:p + 1 + ln].tobytes().decode()
                out.append(Variant(p, seq, r0, hap, "del"))
                taken[max(0, p - 300):p + ln + 300] = True
    # het SNVs, at least 50 bp apart and away from the SVs
    n = 0
    tries = 0
    while n < cfg.n_snv and tries < 100 * cfg.n_snv:
        tries += 1
        p = int(rng.integers(200, L - 200))
        if taken[p]:
            continue
        taken[max(0, p - 50):p + 50] = True
        r0 = chr(ref[p])
        alt = chr(_BASES[(int(np.nonzero(_BASES == ref[p])[0][0])
                          + int(rng.integers(1, 4))) % 4])
        out.append(Variant(p, r0, alt, int(rng.integers(1, 3)), "snv"))
        n += 1
    out.sort(key=lambda v: v.pos)
    return out


def _haplotype(ref: np.ndarray, variants: List[Variant], hap: int):
    """Sequence of haplotype `hap` and its map to the reference (-1 for
    inserted bases)."""
    seqs, maps = [], []
    cur = 0
    for v in variants:
        if v.hap != hap:
            continue
        seqs.append(ref[cur:v.pos])
        maps.append(np.arange(cur, v.pos))
        alt = np.frombuffer(v.alt.encode(), dtype=np.uint8)
        if v.kind == "snv":
            seqs.append(alt)
            maps.append(np.array([v.pos]))
            cur = v.pos + 1
        elif v.kind == "ins":
            seqs.append(alt)
            maps.append(np.concatenate([[v.pos],
                                        np.full(len(alt) - 1, -1)]))
            cur = v.pos + 1
        else:  # deletion keeps the first REF base
            seqs.append(alt)
            maps.append(np.array([v.pos]))
            cur = v.pos + len(v.ref)
    seqs.append(ref[cur:])
    maps.append(np.arange(cur, len(ref)))
    return (np.concatenate(seqs).astype(np.uint8),
            np.concatenate(maps).astype(np.int64))


def _read_alignment(rng, cfg: SynthConfig, hap_seq, hap_map, start, end):
    """Sample one read from hap_seq[start:end] with errors; returns
    (ref_pos, cigar, read bases) or None if nothing aligns."""
    hb = hap_seq[start:end]
    m = hap_map[start:end]
    n = len(hb)
    u = rng.random(n)
    deleted = u < cfg.p_del
    sub = (u >= cfg.p_del) & (u < cfg.p_del + cfg.p_sub)
    hb = hb.copy()
    shift = rng.integers(1, 4, int(sub.sum()))
    idx = np.searchsorted(_BASES, hb[sub])
    hb[sub] = _BASES[(idx + shift) % 4]
    ins = (rng.random(n) < cfg.p_ins).astype(np.int64)
    mapped = m >= 0
    # reference bases skipped before each mapped hap base (haplotype
    # deletions), none before the read's first mapped base
    last = np.maximum.accumulate(np.where(mapped, m, -1))
    prev = np.concatenate([[-1], last[:-1]])
    dref = np.where(mapped & (prev >= 0), m - prev - 1, 0)
    keep_op = np.where(mapped, np.where(deleted, D, M),
                       np.where(deleted, -1, I))
    keep_n = (keep_op >= 0).astype(np.int64)
    seg_n = np.stack([dref, ins, keep_n], axis=1).ravel()
    seg_op = np.stack([np.full(n, D), np.full(n, I), keep_op],
                      axis=1).ravel()
    cols = np.repeat(seg_op, seg_n)
    emit_n = np.stack([np.zeros(n, np.int64), ins,
                       (keep_op == M) | (keep_op == I)], axis=1).ravel()
    seg_id = np.repeat(np.arange(3 * n), emit_n.astype(np.int64))
    kind = seg_id % 3
    rnd = _BASES[rng.integers(0, 4, len(seg_id))]
    bases = np.where(kind == 2, hb[seg_id // 3], rnd).astype(np.uint8)
    is_m = np.nonzero(cols == M)[0]
    if len(is_m) == 0:
        return None
    first, last_m = int(is_m[0]), int(is_m[-1])
    lead, trail = cols[:first], cols[last_m + 1:]
    body = cols[first:last_m + 1]
    first_ref = int(m[np.nonzero(mapped)[0][0]])
    pos = first_ref + int((lead == D).sum())
    clip_l, clip_r = int((lead == I).sum()), int((trail == I).sum())
    cigar = []
    if clip_l:
        cigar.append((S, clip_l))
    change = np.nonzero(np.diff(body))[0] + 1
    starts = np.concatenate([[0], change])
    lens = np.diff(np.concatenate([starts, [len(body)]]))
    cigar += [(int(body[s]), int(ln)) for s, ln in zip(starts, lens)]
    if clip_r:
        cigar.append((S, clip_r))
    return pos, cigar, bases


def write_dataset(out_dir: str, cfg: SynthConfig) -> SynthDataset:
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(out_dir, exist_ok=True)
    ref = _BASES[rng.integers(0, 4, cfg.contig_len)]
    variants = _place_variants(rng, cfg, ref)
    haps = {h: _haplotype(ref, variants, h) for h in (1, 2)}

    fasta = os.path.join(out_dir, "ref.fa")
    write_fasta(fasta, [(cfg.contig, ref.tobytes().decode())])

    vcf = os.path.join(out_dir, "calls.vcf")
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write(f"##contig=<ID={cfg.contig},length={cfg.contig_len}>\n")
        fh.write('##FORMAT=<ID=GT,Number=1,Type=String,'
                 'Description="Genotype">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                 "\tSAMPLE\n")
        for v in variants:
            info = "." if v.kind == "snv" else \
                f"SVTYPE={'INS' if v.kind == 'ins' else 'DEL'}"
            fh.write(f"{cfg.contig}\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t50"
                     f"\tPASS\t{info}\tGT\t0/1\n")

    # reads: per haplotype, half the coverage each, both strands
    records = []
    read_hap: Dict[str, int] = {}
    lo, hi = cfg.read_len
    target = cfg.coverage * cfg.contig_len
    total, idx = 0, 0
    while total < target:
        h = 1 + idx % 2
        seq, hmap = haps[h]
        ln = int(rng.integers(lo, hi + 1))
        ln = min(ln, len(seq))
        start = int(rng.integers(0, len(seq) - ln + 1))
        aln = _read_alignment(rng, cfg, seq, hmap, start, start + ln)
        if aln is None:
            continue
        pos, cigar, bases = aln
        name = f"read{idx:06d}_h{h}"
        reverse = bool(rng.integers(0, 2))
        quals = rng.integers(8, 30, len(bases)).astype(np.uint8).tobytes()
        raw = build_bam_record(name, 16 if reverse else 0, 0, pos, 60, cigar,
                               bases.tobytes(), quals)
        records.append((pos, name, raw))
        read_hap[name] = h
        total += len(bases)
        idx += 1
    records.sort(key=lambda r: (r[0], r[1]))
    bam = os.path.join(out_dir, "reads.bam")
    header = bamio.BamHeader(
        f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{cfg.contig}\t"
        f"LN:{cfg.contig_len}\n", [cfg.contig], [cfg.contig_len])
    with bamio.BamWriter(bam, header) as w:
        for _, _, raw in records:
            w.write_raw(raw)
    bamio.build_bai(bam)

    params = os.path.join(out_dir, "params.json")
    sm = StateMachineParams.default_nucleotide()
    with open(params, "w") as fh:
        json.dump({"polish": {"hmmForwardStrandReadGivenReference":
                              hmm_json(sm)},
                   "phase": {"indelSizeForSVHandling": cfg.sv_handling,
                             "referenceExpansionForStructuralVariants":
                                 cfg.sv_expansion}}, fh, indent=1)
    return SynthDataset(bam, fasta, vcf, params, cfg.contig, variants,
                        read_hap)


# ---------------------------------------------------------------------------
# margin polish
# ---------------------------------------------------------------------------

@dataclass
class PolishSynthConfig:
    contig: str = "contig1"
    contig_len: int = 12_000
    coverage: float = 10.0
    read_len: Tuple[int, int] = (1500, 4000)
    draft_error_every: int = 200     # one draft error per this many bases
    homopolymer_bias: float = 0.6    # share of draft errors put in runs
    p_sub: float = 0.03              # read errors
    p_ins: float = 0.02
    p_del: float = 0.03
    chunk_size: int = 5000
    chunk_boundary: int = 500
    # polish.maxPoaConsensusIterations (the POA's profile-HMM consensus,
    # each followed by a realignment) and maxRealignmentPolishIterations
    # (bubble consensus with dense allele scoring; the params set
    # minRealignmentPolishIterations to 0, so a bubble pass that does not
    # raise the realigned score is dropped). These are not the package
    # defaults (0 / 1 / 1) nor a published margin config: with the
    # defaults the bubble pass alone makes these drafts worse, in both
    # packages alike (the suspected bubble off-by-one, ROADMAP queue 3)
    poa_consensus_iterations: int = 3
    realign_polish_iterations: int = 1
    seed: int = 0


@dataclass
class PolishDataset:
    bam: str
    draft: str
    truth: str
    params: str
    contig: str
    draft_edits: List[Variant] = field(default_factory=list)
    truth_bam: str = ""


def _exact_cigar(hap_map: np.ndarray):
    """(pos, cigar) of a haplotype aligned to the sequence it was made
    from, exactly, by its map (-1 for inserted bases): D for skipped
    bases of that sequence, I for inserted ones, soft clips for inserted
    ends."""
    mapped = np.nonzero(hap_map >= 0)[0]
    first, last = int(mapped[0]), int(mapped[-1])
    ops = [(S, first)] if first else []
    prev = int(hap_map[first]) - 1
    for p in hap_map[first:last + 1]:
        p = int(p)
        if p < 0:
            ops.append((I, 1))
            continue
        if p > prev + 1:
            ops.append((D, p - prev - 1))
        ops.append((M, 1))
        prev = p
    if last + 1 < len(hap_map):
        ops.append((S, len(hap_map) - 1 - last))
    cigar = []
    for op, n in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + n)
        else:
            cigar.append((op, n))
    return int(hap_map[first]), cigar


def write_truth_bam(path: str, header, haps) -> str:
    """truth.bam(.bai): each truth haplotype, [(name, sequence, map to
    the draft)], as one record aligned to the draft with the exact CIGAR
    its map gives (a truth assembly aligned to the draft, as HELEN's -u
    and the truth-haplotype partition read it)."""
    records = []
    for name, seq, hmap in haps:
        pos, cigar = _exact_cigar(hmap)
        records.append((pos, name, build_bam_record(
            name, 0, 0, pos, 60, cigar, seq.tobytes(),
            bytes([30]) * len(seq))))
    records.sort(key=lambda r: (r[0], r[1]))
    with bamio.BamWriter(path, header) as w:
        for _, _, raw in records:
            w.write_raw(raw)
    bamio.build_bai(path)
    return path


def _draft_from_truth(rng, cfg: PolishSynthConfig, truth: np.ndarray):
    """The draft: the truth with substitutions and 1-3 bp insertions and
    deletions about every cfg.draft_error_every bases, a share of them in
    homopolymer runs. Returns (draft, the edits that turn the draft back
    into the truth, as homozygous Variants in draft coordinates)."""
    L = len(truth)
    run_start = np.concatenate([[True], truth[1:] != truth[:-1]])
    run_id = np.cumsum(run_start) - 1
    run_len = np.bincount(run_id)[run_id]
    in_runs = np.nonzero(run_len >= 3)[0]
    n_err = max(1, L // cfg.draft_error_every)
    sites = set()
    while len(sites) < n_err:
        if len(in_runs) and rng.random() < cfg.homopolymer_bias:
            t = int(in_runs[rng.integers(0, len(in_runs))])
        else:
            t = int(rng.integers(0, L))
        if 20 <= t < L - 20 and not any(abs(t - u) < 12 for u in sites):
            sites.add(t)
    pieces, edits = [], []
    cur = dlen = 0        # next truth base to copy, draft length so far
    for t in sorted(sites):
        pieces.append(truth[cur:t])
        dlen += t - cur
        kind = rng.choice(["snv", "ins", "del"], p=[0.4, 0.3, 0.3])
        n = int(rng.integers(1, 4))
        b = truth[t]
        if kind == "snv":
            alt = _BASES[(int(np.searchsorted(_BASES, b))
                          + int(rng.integers(1, 4))) % 4]
            pieces.append(np.array([alt], np.uint8))
            edits.append(Variant(dlen, chr(alt), chr(b), 1, "snv"))
            dlen, cur = dlen + 1, t + 1
        elif kind == "ins":
            # the draft carries n extra bases after truth[t]: copies of the
            # run's base inside a homopolymer, random bases elsewhere
            extra = (np.full(n, b, np.uint8) if run_len[t] >= 3
                     else _BASES[rng.integers(0, 4, n)])
            ref = np.concatenate([[b], extra]).astype(np.uint8)
            pieces.append(ref)
            edits.append(Variant(dlen, ref.tobytes().decode(), chr(b), 1,
                                 "del"))
            dlen, cur = dlen + len(ref), t + 1
        else:
            # the draft lacks truth[t+1 .. t+n]
            alt = truth[t:t + n + 1]
            pieces.append(np.array([b], np.uint8))
            edits.append(Variant(dlen, chr(b), alt.tobytes().decode(), 1,
                                 "ins"))
            dlen, cur = dlen + 1, t + n + 1
    pieces.append(truth[cur:])
    return np.concatenate(pieces).astype(np.uint8), edits


def _repeat_matrix_json(rng, cfg: PolishSynthConfig, n_sim: int = 4000
                        ) -> dict:
    """A seeded repeat-count substitution matrix for the config's read
    error model, the way margin's matrices are trained on real reads: per
    underlying run length u, n_sim runs of u equal bases pass through
    substitutions, deletions and insertions (a quarter of them the run's
    own base), and the longest surviving run is the observed count. Per
    base 51 x 51 log10 probabilities [underlying][observed], smoothed with
    a small peak on observed = underlying."""
    n = 51
    counts = np.zeros((n, n))
    for u in range(1, n):
        v = rng.random((n_sim, u))
        lost = v < cfg.p_del + cfg.p_sub              # deleted or changed
        changed = v >= cfg.p_del                       # (of the lost ones)
        w = rng.random((n_sim, u))
        ins = w < cfg.p_ins
        same = w < cfg.p_ins / 4
        run = np.zeros(n_sim, np.int64)
        best = np.zeros(n_sim, np.int64)
        for i in range(u):
            run = np.where(lost[:, i] & changed[:, i], 0,
                           run + ~lost[:, i])
            best = np.maximum(best, run)
            run = np.where(ins[:, i], np.where(same[:, i], run + 1, 0), run)
            best = np.maximum(best, run)
        counts[u] += np.bincount(np.minimum(best, n - 1), minlength=n)
    counts[0, 0] += 1.0
    peak = np.exp(-2.0 * np.abs(np.arange(n)[None, :]
                                - np.arange(n)[:, None]))
    prob = counts / n_sim + 1e-3 * peak
    prob /= prob.sum(axis=1, keepdims=True)
    out = {}
    for base in "ACGT":
        out[f"repeatCountLogProbabilities_{base}_F"] = \
            np.log10(prob).ravel().tolist()
    prior = np.log10(np.full(n, 1.0 / n))
    out["baseLogRepeatCounts_AT"] = prior.tolist()
    out["baseLogRepeatCounts_GC"] = prior.tolist()
    return out


def _polish_params(rng, cfg: PolishSynthConfig) -> dict:
    """The polish parameters of a synthetic set: the default nucleotide
    HMM, run-length encoding with the simulated repeat-count matrix, the
    config's chunk geometry and consensus iterations."""
    return {
        "hmmForwardStrandReadGivenReference":
            hmm_json(StateMachineParams.default_nucleotide()),
        "useRunLengthEncoding": True,
        "repeatCountSubstitutionMatrix": _repeat_matrix_json(rng, cfg),
        "chunkSize": cfg.chunk_size,
        "chunkBoundary": cfg.chunk_boundary,
        "maxPoaConsensusIterations": cfg.poa_consensus_iterations,
        "maxRealignmentPolishIterations": cfg.realign_polish_iterations,
        "minRealignmentPolishIterations": 0}


def write_polish_dataset(out_dir: str, cfg: PolishSynthConfig
                         ) -> PolishDataset:
    """Write a seeded `margin polish` input set: truth.fa (a random
    contig), draft.fa (the truth with draft errors), reads.bam(.bai)
    (ONT-like reads from the truth on both strands, aligned to the draft
    by their true alignments), truth.bam(.bai) (the truth aligned to the
    draft by the draft edits, one record named "truth") and params.json
    (the default nucleotide HMM, run-length encoding with a repeat-count
    matrix simulated for the read error model, the config's chunk geometry
    and consensus iterations)."""
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(out_dir, exist_ok=True)
    truth = _BASES[rng.integers(0, 4, cfg.contig_len)]
    draft, edits = _draft_from_truth(rng, cfg, truth)
    # the truth is the draft's haplotype carrying every edit
    hap_seq, hap_map = _haplotype(draft, edits, 1)
    assert np.array_equal(hap_seq, truth)

    truth_fa = os.path.join(out_dir, "truth.fa")
    write_fasta(truth_fa, [(cfg.contig, truth.tobytes().decode())])
    draft_fa = os.path.join(out_dir, "draft.fa")
    write_fasta(draft_fa, [(cfg.contig, draft.tobytes().decode())])

    records = []
    lo, hi = cfg.read_len
    total, idx = 0, 0
    L = len(truth)
    while total < cfg.coverage * L:
        # reads may overhang the contig ends (cut there), so coverage
        # reaches them and the polished contig spans the whole truth
        ln = min(int(rng.integers(lo, hi + 1)), L)
        start = int(rng.integers(-(ln // 2), L - ln // 2 + 1))
        end = min(start + ln, L)
        start = max(start, 0)
        aln = _read_alignment(rng, cfg, hap_seq, hap_map, start, end)
        if aln is None:
            continue
        pos, cigar, bases = aln
        name = f"read{idx:06d}"
        reverse = bool(rng.integers(0, 2))
        quals = rng.integers(8, 30, len(bases)).astype(np.uint8).tobytes()
        records.append((pos, name, build_bam_record(
            name, 16 if reverse else 0, 0, pos, 60, cigar, bases.tobytes(),
            quals)))
        total += len(bases)
        idx += 1
    records.sort(key=lambda r: (r[0], r[1]))
    bam = os.path.join(out_dir, "reads.bam")
    header = bamio.BamHeader(
        f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{cfg.contig}\t"
        f"LN:{len(draft)}\n", [cfg.contig], [len(draft)])
    with bamio.BamWriter(bam, header) as w:
        for _, _, raw in records:
            w.write_raw(raw)
    bamio.build_bai(bam)

    params = os.path.join(out_dir, "params.json")
    with open(params, "w") as fh:
        json.dump({"polish": _polish_params(rng, cfg)}, fh)
    truth_bam = write_truth_bam(os.path.join(out_dir, "truth.bam"), header,
                                [("truth", hap_seq, hap_map)])
    return PolishDataset(bam, draft_fa, truth_fa, params, cfg.contig, edits,
                         truth_bam)


# ---------------------------------------------------------------------------
# margin polish --diploid
# ---------------------------------------------------------------------------

@dataclass
class DiploidPolishSynthConfig(PolishSynthConfig):
    coverage: float = 30.0           # both haplotypes together
    read_len: Tuple[int, int] = (5000, 30000)
    # one het site per this many draft bases (drawn uniformly), human
    # heterozygosity: SNVs and 1-10 bp insertions and deletions
    het_every: Tuple[int, int] = (1000, 1500)
    het_indel_fraction: float = 0.3
    het_indel_len: Tuple[int, int] = (1, 10)


@dataclass
class DiploidPolishDataset:
    bam: str
    draft: str
    truth1: str                      # the draft's haplotype
    truth2: str
    vcf: str                         # the het sites in draft coordinates
    params: str
    contig: str
    hets: List[Variant] = field(default_factory=list)
    draft_edits: List[Variant] = field(default_factory=list)
    read_hap: Dict[str, int] = field(default_factory=dict)
    truth_bam: str = ""


def _place_hets(rng, cfg: DiploidPolishSynthConfig, draft: np.ndarray,
                edits: List[Variant]) -> List[Variant]:
    """Het variants on haplotype 2 in draft coordinates, one per
    cfg.het_every bases, each at least 15 bases from a draft edit."""
    L = len(draft)
    near = np.zeros(L + 1, dtype=bool)
    for e in edits:
        near[max(0, e.pos - 15):e.pos + len(e.ref) + 15] = True
    out: List[Variant] = []
    p = int(rng.integers(*cfg.het_every)) // 2
    while p < L - 50:
        n = int(rng.integers(cfg.het_indel_len[0], cfg.het_indel_len[1] + 1))
        if near[p:p + n + 2].any():
            p += 7
            continue
        b = chr(draft[p])
        if rng.random() >= cfg.het_indel_fraction:
            alt = chr(_BASES[(int(np.searchsorted(_BASES, draft[p]))
                              + int(rng.integers(1, 4))) % 4])
            out.append(Variant(p, b, alt, 2, "snv"))
        elif rng.random() < 0.5:
            ins = _BASES[rng.integers(0, 4, n)].tobytes().decode()
            out.append(Variant(p, b, b + ins, 2, "ins"))
        else:
            out.append(Variant(p, draft[p:p + n + 1].tobytes().decode(), b,
                               2, "del"))
        p += len(out[-1].ref) + int(rng.integers(*cfg.het_every))
    return out


def write_diploid_polish_dataset(out_dir: str, cfg: DiploidPolishSynthConfig
                                 ) -> DiploidPolishDataset:
    """Write a seeded `margin polish --diploid` input set: truth1.fa and
    truth2.fa (two haplotypes that differ at the het sites), draft.fa
    (haplotype 1 with the draft edits of PolishSynthConfig), calls.vcf
    (the het sites as unphased 0/1 calls on the draft), reads.bam(.bai)
    (ONT-like reads drawn alternately from the two haplotypes on both
    strands, aligned to the draft by their true alignments, named
    "..._h1" / "..._h2" after their haplotype), truth.bam(.bai) (the two
    haplotypes aligned to the draft by their edits, records "truth1" and
    "truth2") and params.json (as write_polish_dataset, with
    polish.skipHaploidPolishingIfDiploid)."""
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(out_dir, exist_ok=True)
    truth1 = _BASES[rng.integers(0, 4, cfg.contig_len)]
    draft, edits = _draft_from_truth(rng, cfg, truth1)
    hets = _place_hets(rng, cfg, draft, edits)
    both = sorted([Variant(e.pos, e.ref, e.alt, 2, e.kind) for e in edits]
                  + hets, key=lambda v: v.pos)
    haps = {1: _haplotype(draft, edits, 1), 2: _haplotype(draft, both, 2)}
    assert np.array_equal(haps[1][0], truth1)

    paths = {}
    for name, seq in (("truth1", haps[1][0]), ("truth2", haps[2][0]),
                      ("draft", draft)):
        paths[name] = os.path.join(out_dir, f"{name}.fa")
        write_fasta(paths[name], [(cfg.contig, seq.tobytes().decode())])

    vcf = os.path.join(out_dir, "calls.vcf")
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write(f"##contig=<ID={cfg.contig},length={len(draft)}>\n")
        fh.write('##FORMAT=<ID=GT,Number=1,Type=String,'
                 'Description="Genotype">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                 "\tSAMPLE\n")
        for v in hets:
            fh.write(f"{cfg.contig}\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t50"
                     f"\tPASS\t.\tGT\t0/1\n")

    records = []
    read_hap: Dict[str, int] = {}
    lo, hi = cfg.read_len
    total, idx = 0, 0
    while total < cfg.coverage * len(draft):
        h = 1 + idx % 2
        seq, hmap = haps[h]
        L = len(seq)
        ln = min(int(rng.integers(lo, hi + 1)), L)
        start = int(rng.integers(-(ln // 2), L - ln // 2 + 1))
        end = min(start + ln, L)
        start = max(start, 0)
        aln = _read_alignment(rng, cfg, seq, hmap, start, end)
        if aln is None:
            continue
        pos, cigar, bases = aln
        name = f"read{idx:06d}_h{h}"
        reverse = bool(rng.integers(0, 2))
        quals = rng.integers(8, 30, len(bases)).astype(np.uint8).tobytes()
        records.append((pos, name, build_bam_record(
            name, 16 if reverse else 0, 0, pos, 60, cigar, bases.tobytes(),
            quals)))
        read_hap[name] = h
        total += len(bases)
        idx += 1
    records.sort(key=lambda r: (r[0], r[1]))
    bam = os.path.join(out_dir, "reads.bam")
    header = bamio.BamHeader(
        f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{cfg.contig}\t"
        f"LN:{len(draft)}\n", [cfg.contig], [len(draft)])
    with bamio.BamWriter(bam, header) as w:
        for _, _, raw in records:
            w.write_raw(raw)
    bamio.build_bai(bam)

    params = os.path.join(out_dir, "params.json")
    with open(params, "w") as fh:
        json.dump({"polish": dict(_polish_params(rng, cfg),
                                  skipHaploidPolishingIfDiploid=True)}, fh)
    truth_bam = write_truth_bam(
        os.path.join(out_dir, "truth.bam"), header,
        [(f"truth{h}", haps[h][0], haps[h][1]) for h in (1, 2)])
    return DiploidPolishDataset(bam, paths["draft"], paths["truth1"],
                                paths["truth2"], vcf, params, cfg.contig,
                                hets, edits, read_hap, truth_bam)


def banded_edit_distance(a: str, b: str, band: int = 500) -> int:
    """Levenshtein distance of a and b over the alignments that stay within
    `band` columns of the line from (0, 0) to (len(a), len(b)): exact when
    the best alignment stays in it, an upper bound otherwise. Row by row
    over the band, the in-row insertions as one running minimum:
    O(len(a) * band) numpy work."""
    x = np.frombuffer(a.encode(), dtype=np.uint8)
    y = np.frombuffer(b.encode(), dtype=np.uint8)
    n, m = len(x), len(y)
    if n == 0 or m == 0:
        return n + m
    big = np.int64(1) << 40
    W = 2 * band + 1
    off = np.arange(-band, band + 1, dtype=np.int64)  # column j = c_i + off
    centre = (np.arange(n + 1, dtype=np.int64) * m) // n
    step = int(np.diff(centre).max(initial=0))
    # y with a sentinel margin: row i's characters y[j-1] are the slice
    # yp[c_i + 1 : c_i + 1 + W]
    fill = np.full(band + 2, 255, np.uint8)
    yp = np.concatenate([fill, y, fill])
    # buf[1 + k] holds the previous row at band slot k; big around it
    buf = np.full(W + step + 2, big)
    row0 = off.copy()                                 # dp[0][j] = j
    row0[(off < 0) | (off > m)] = big
    buf[1:W + 1] = row0
    for i in range(1, n + 1):
        c = int(centre[i])
        s = c - int(centre[i - 1])
        # the band moved by s columns: column j of the previous row is at
        # slot k + s, column j - 1 at slot k + s - 1
        up = buf[1 + s:1 + s + W]
        diag = buf[s:s + W]
        t = np.minimum(diag + (yp[c + 1:c + 1 + W] != x[i - 1]), up + 1)
        k0 = band - c                                 # the slot of j = 0
        if 0 <= k0 < W:
            t[k0] = i
        cur = np.minimum.accumulate(t - off) + off    # left (i, j-1) + 1
        k_end = m - c + band                          # the slot of j = m
        if k_end < W - 1:
            cur[k_end + 1:] = big
        if k0 > 0:
            cur[:k0] = big
        buf[1:W + 1] = cur
    return int(buf[1 + m - int(centre[n]) + band])
