"""The benchmark's seeded generator of `margin phase` and `margin polish`
inputs: one general generator that every traffic mix parameterises.

A frozen copy of the port's `testing/synth.py` phase and haploid polish
writers (read sampling, draft errors, the repeat-count matrix), with the
benchmark's own file writers (`formats.py`) and these changes:

  * phase sets carry het small indels of 1-10 bp beside the het SNVs, and
    het SVs at a density per Mb;
  * sizes come as a fixed multiset that the seed only reorders: the gaps
    between het sites, the SV lengths, the read lengths and the kinds of
    the draft errors are evenly spaced over their ranges and shuffled, so
    every seed gives the same amount of work in another order;
  * CIGARs and records are built as arrays.

`generate(out_dir, kind, spec, seed)` writes the set and returns a
`Dataset` with the truth the comparison needs: the het sites and each
read's haplotype (phase), the truth contig (polish).
"""

from __future__ import annotations

import json
import math
import os
import pickle
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from portbench.traffic import formats

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
M, I, D, S = 0, 1, 2, 4


@dataclass
class Variant:
    pos: int          # 0-based reference position of the first REF base
    ref: str
    alt: str
    hap: int          # haplotype (1 or 2) carrying ALT
    kind: str         # "snv", "ins" or "del"


@dataclass
class Dataset:
    kind: str
    contig: str
    length: int
    bam: str
    fasta: str
    params: str
    vcf: Optional[str] = None
    variants: List[Variant] = field(default_factory=list)
    read_hap: Dict[str, int] = field(default_factory=dict)
    truth: Optional[bytes] = None
    truth_map: Optional[np.ndarray] = None
    n_reads: int = 0
    read_bases: int = 0

    def truth_segment(self, lo: int, hi: int) -> bytes:
        """The truth's bases that the draft's [lo, hi) stands for: those
        whose draft position (an inserted base: its predecessor's) lies
        in [lo, hi)."""
        pos = np.maximum.accumulate(np.where(self.truth_map >= 0,
                                             self.truth_map, -1))
        keep = (pos >= lo) & (pos < hi)
        return np.frombuffer(self.truth, np.uint8)[keep].tobytes()


def spread(rng, lo: float, hi: float, n: int, integer: bool = True):
    """n values evenly spaced over [lo, hi], in an order drawn from rng."""
    v = np.linspace(lo, hi, n) if n > 1 else np.array([(lo + hi) / 2.0])
    v = v[rng.permutation(n)]
    return np.rint(v).astype(np.int64) if integer else v


def _other_base(rng, b: int) -> int:
    return int(_BASES[(int(np.searchsorted(_BASES, b))
                       + int(rng.integers(1, 4))) % 4])


# ---------------------------------------------------------------------------
# haplotypes and reads
# ---------------------------------------------------------------------------

def haplotype(ref: np.ndarray, variants: List[Variant], hap: int):
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
        seqs.append(alt)
        if v.kind == "ins":
            maps.append(np.concatenate([[v.pos], np.full(len(alt) - 1, -1)]))
        else:                 # an SNV, or a deletion keeping its first base
            maps.append(np.array([v.pos]))
        cur = v.pos + len(v.ref)
    seqs.append(ref[cur:])
    maps.append(np.arange(cur, len(ref)))
    return (np.concatenate(seqs).astype(np.uint8),
            np.concatenate(maps).astype(np.int64))


def read_alignment(rng, err, hap_seq, hap_map, start, end):
    """Sample one read from hap_seq[start:end] with substitution,
    insertion and deletion errors (err: p_sub, p_ins, p_del). Returns
    (ref pos, CIGAR ops, CIGAR lengths, read bases) or None."""
    p_sub, p_ins, p_del = err
    hb = hap_seq[start:end]
    m = hap_map[start:end]
    n = len(hb)
    u = rng.random(n)
    deleted = u < p_del
    sub = (u >= p_del) & (u < p_del + p_sub)
    hb = hb.copy()
    shift = rng.integers(1, 4, int(sub.sum()))
    idx = np.searchsorted(_BASES, hb[sub])
    hb[sub] = _BASES[(idx + shift) % 4]
    ins = (rng.random(n) < p_ins).astype(np.int64)
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
    seg_op = np.stack([np.full(n, D), np.full(n, I), keep_op], axis=1).ravel()
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
    pos = int(m[np.nonzero(mapped)[0][0]]) + int((lead == D).sum())
    clip_l, clip_r = int((lead == I).sum()), int((trail == I).sum())
    change = np.nonzero(np.diff(body))[0] + 1
    starts = np.concatenate([[0], change])
    lens = np.diff(np.concatenate([starts, [len(body)]]))
    ops = body[starts]
    if clip_l:
        ops, lens = np.concatenate([[S], ops]), np.concatenate([[clip_l], lens])
    if clip_r:
        ops, lens = np.concatenate([ops, [S]]), np.concatenate([lens, [clip_r]])
    return pos, ops.astype(np.int64), lens.astype(np.int64), bases


SHARDS = 8          # read streams; the files do not depend on the workers


def _read_shard(args):
    """Reads of one shard: (index, haplotype, length) each, from the
    shard's own stream."""
    haps, err, plan, seed, names_hap, overhang = args
    rng = np.random.default_rng(seed)
    out = []
    for idx, h, ln in plan:
        seq, hmap = haps[h - 1]
        L = len(seq)
        ln = int(min(ln, L))
        if overhang:
            start = int(rng.integers(-(ln // 2), L - ln // 2 + 1))
            end, start = min(start + ln, L), max(start, 0)
        else:
            start = int(rng.integers(0, L - ln + 1))
            end = start + ln
        aln = read_alignment(rng, err, seq, hmap, start, end)
        if aln is None:
            continue
        pos, ops, lens, bases = aln
        name = f"read{idx:06d}_h{h}" if names_hap else f"read{idx:06d}"
        quals = rng.integers(8, 30, len(bases)).astype(np.uint8)
        raw = formats.bam_record(name, 16 if rng.integers(0, 2) else 0, pos,
                                 ops, lens, bases, quals)
        span = int(lens[(ops == M) | (ops == D)].sum()) or 1
        out.append((pos, pos + span, name, h, len(bases), raw))
    return out


_SHARD_MAIN = ("import pickle, sys; sys.path.insert(0, sys.argv[1]); "
               "from portbench.traffic import synth; "
               "sys.stdout.buffer.write(pickle.dumps(synth._read_shard("
               "pickle.load(sys.stdin.buffer))))")


def _run_shards(jobs):
    """_read_shard of each job, each in a Python process of its own (a
    fresh interpreter that imports this module alone), all at once."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen([sys.executable, "-c", _SHARD_MAIN, root],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
             for _ in jobs]
    try:
        for p, job in zip(procs, jobs):
            p.stdin.write(pickle.dumps(job))
            p.stdin.close()
        out = [pickle.loads(p.stdout.read()) for p in procs]
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        for p in procs:
            p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("a read shard's process failed")
    return out


def _reads(rng, spec, haps, n_target_bases, names_hap: bool):
    """Reads drawn alternately from the haplotypes (one for a haploid
    set), lengths from the spec's range as a shuffled evenly spaced
    multiset, starts uniform; polish reads may overhang the contig ends
    (cut there). SHARDS streams seeded from rng, each in a process of its
    own where there are many reads. Returns (records, read_hap, bases)."""
    lo, hi = spec["read_len"]
    err = (spec["p_sub"], spec["p_ins"], spec["p_del"])
    n = max(1, int(math.ceil(n_target_bases / ((lo + hi) / 2.0))))
    lengths = spread(rng, lo, hi, n)
    seeds = rng.integers(0, 2 ** 62, SHARDS)
    jobs = [(haps, err, [(i, 1 + i % len(haps), int(lengths[i]))
                         for i in range(s, n, SHARDS)], int(seeds[s]),
             names_hap, spec.get("overhang", False)) for s in range(SHARDS)]
    shards = (_run_shards(jobs) if n >= 64 and (os.cpu_count() or 1) > 1
              else [_read_shard(j) for j in jobs])
    records = sorted((r for sh in shards for r in sh),
                     key=lambda r: (r[0], r[2]))
    read_hap = {r[2]: r[3] for r in records}
    total = sum(r[4] for r in records)
    return [(p, e, raw) for p, e, _, _, _, raw in records], read_hap, total


# ---------------------------------------------------------------------------
# the pair-HMM parameters
# ---------------------------------------------------------------------------

# The default nucleotide pair-HMM of margin (stateMachine.c:409-432,
# 612-622) in natural logs: transitions (match continue, match from gap X
# and Y, gap open X and Y, extend X and Y, switch to X and Y) and the 4x4
# match and gap emissions.
_DEFAULT_T = (-0.030064059121770816, -1.272871422049609, -1.272871422049609,
              -4.21256642, -4.21256642, -0.3388262689231553,
              -0.3388262689231553, -4.910694825551255, -4.910694825551255)
_EM, _ET, _EV = -1.8917761142, -3.760242452, -4.3459578861
_DEFAULT_MATCH = np.array([[_EM, _EV, _ET, _EV], [_EV, _EM, _EV, _ET],
                           [_ET, _EV, _EM, _EV], [_EV, _ET, _EV, _EM]])
_DEFAULT_GAP = -1.3862943611


def default_hmm_json() -> dict:
    """The default nucleotide HMM as margin's asymmetric (type 3) trained
    HMM JSON: 3x3 transitions [from][to] over (match, gap X, gap Y) and
    16 match + 4 gap X + 4 gap Y emission probabilities."""
    (mm, m_gx, m_gy, o_x, o_y, e_x, e_y, s_x, s_y) = _DEFAULT_T
    e = math.exp
    trans = [[e(mm), e(o_x), e(o_y)], [e(m_gx), e(e_x), e(s_y)],
             [e(m_gy), e(s_x), e(e_y)]]
    emissions = (np.exp(_DEFAULT_MATCH).ravel().tolist()
                 + [e(_DEFAULT_GAP)] * 8)
    return {"type": 3, "emissionsType": 0,
            "transitions": [v for row in trans for v in row],
            "emissions": emissions}


def repeat_matrix_json(rng, err, n_sim: int = 4000) -> dict:
    """A seeded repeat-count substitution matrix for the read error model
    (a frozen copy of the port's synth `_repeat_matrix_json`): per
    underlying run length u, n_sim runs of u equal bases pass through
    substitutions, deletions and insertions (a quarter of them the run's
    own base), the longest surviving run is the observed count; per base
    51 x 51 log10 probabilities [underlying][observed], smoothed with a
    small peak on observed = underlying."""
    p_sub, p_ins, p_del = err
    n = 51
    counts = np.zeros((n, n))
    for u in range(1, n):
        v = rng.random((n_sim, u))
        lost = v < p_del + p_sub
        changed = v >= p_del
        w = rng.random((n_sim, u))
        ins = w < p_ins
        same = w < p_ins / 4
        run = np.zeros(n_sim, np.int64)
        best = np.zeros(n_sim, np.int64)
        for i in range(u):
            run = np.where(lost[:, i] & changed[:, i], 0, run + ~lost[:, i])
            best = np.maximum(best, run)
            run = np.where(ins[:, i], np.where(same[:, i], run + 1, 0), run)
            best = np.maximum(best, run)
        counts[u] += np.bincount(np.minimum(best, n - 1), minlength=n)
    counts[0, 0] += 1.0
    peak = np.exp(-2.0 * np.abs(np.arange(n)[None, :]
                                - np.arange(n)[:, None]))
    prob = counts / n_sim + 1e-3 * peak
    prob /= prob.sum(axis=1, keepdims=True)
    out = {f"repeatCountLogProbabilities_{b}_F": np.log10(prob).ravel()
           .tolist() for b in "ACGT"}
    prior = np.log10(np.full(n, 1.0 / n)).tolist()
    out["baseLogRepeatCounts_AT"] = prior
    out["baseLogRepeatCounts_GC"] = list(prior)
    return out


def params_json(rng, spec: dict) -> dict:
    """The params file the CLI would be given: the spec's `params` blocks
    with the synthetic HMM in place of a trained one and, where the spec
    asks (`repeat_matrix`), the simulated repeat-count matrix."""
    doc = json.loads(json.dumps(spec.get("params", {})))
    pol = doc.setdefault("polish", {})
    pol["hmmForwardStrandReadGivenReference"] = default_hmm_json()
    if spec.get("repeat_matrix"):
        pol["repeatCountSubstitutionMatrix"] = repeat_matrix_json(
            rng, (spec["p_sub"], spec["p_ins"], spec["p_del"]))
    return doc


# ---------------------------------------------------------------------------
# margin phase
# ---------------------------------------------------------------------------

def _phase_variants(rng, spec, ref: np.ndarray) -> List[Variant]:
    """Het SVs at spec["sv_per_mb"] in evenly spaced jittered slots, then
    het small variants every spec["het_every"] bases (gaps evenly spaced
    over the range, shuffled), a spec["indel_fraction"] share of them
    insertions or deletions of spec["indel_len"] bases, kept 300 bp from
    the SVs."""
    L = len(ref)
    out: List[Variant] = []
    taken = np.zeros(L + 1, dtype=bool)
    n_sv = int(round(spec.get("sv_per_mb", 0) * L / 1e6))
    if n_sv:
        lo, hi = spec["sv_len"]
        short_max = spec.get("sv_short_max", hi)
        n_short = int(round(spec.get("sv_short_fraction", 1.0) * n_sv))
        lens = np.concatenate([spread(rng, lo, min(hi, short_max), n_short),
                               spread(rng, max(lo, short_max), hi,
                                      n_sv - n_short)])[rng.permutation(n_sv)]
        slot = L / n_sv
        for j in range(n_sv):
            ln = int(lens[j])
            p = int(slot * j + slot / 2 + rng.integers(-int(slot / 4),
                                                       int(slot / 4) + 1))
            p = min(max(p, 2000), L - ln - 2000)
            hap = 1 + j % 2
            r0 = chr(ref[p])
            if j % 4 in (0, 3):
                ins = _BASES[rng.integers(0, 4, ln)].tobytes().decode()
                out.append(Variant(p, r0, r0 + ins, hap, "ins"))
                taken[max(0, p - 300):p + 300] = True
            else:
                out.append(Variant(p, ref[p:p + 1 + ln].tobytes().decode(),
                                   r0, hap, "del"))
                taken[max(0, p - 300):p + ln + 300] = True
    lo, hi = spec["het_every"]
    n_small = int(L / ((lo + hi) / 2.0))
    gaps = spread(rng, lo, hi, n_small)
    n_indel = int(round(spec.get("indel_fraction", 0.0) * n_small))
    is_indel = np.zeros(n_small, dtype=bool)
    is_indel[:n_indel] = True
    is_indel = is_indel[rng.permutation(n_small)]
    ilo, ihi = spec.get("indel_len", (1, 1))
    indel_lens = spread(rng, ilo, ihi, max(n_indel, 1))
    p = int(gaps[0]) // 2
    k_indel = 0
    for j in range(n_small):
        if p >= L - 200:
            break
        pos = p
        p += int(gaps[(j + 1) % n_small])
        if taken[max(0, pos - 20):pos + 20].any():
            continue
        hap = int(rng.integers(1, 3))
        r0 = chr(ref[pos])
        if not is_indel[j]:
            out.append(Variant(pos, r0, chr(_other_base(rng, ref[pos])), hap,
                               "snv"))
            continue
        n = int(indel_lens[k_indel % len(indel_lens)])
        k_indel += 1
        if k_indel % 2:
            ins = _BASES[rng.integers(0, 4, n)].tobytes().decode()
            out.append(Variant(pos, r0, r0 + ins, hap, "ins"))
        else:
            out.append(Variant(pos, ref[pos:pos + n + 1].tobytes().decode(),
                               r0, hap, "del"))
    out.sort(key=lambda v: v.pos)
    return out


def _phase_set(out_dir: str, spec: dict, rng) -> Dataset:
    contig, L = spec.get("contig", "chr1"), int(spec["contig_len"])
    ref = _BASES[rng.integers(0, 4, L)]
    variants = _phase_variants(rng, spec, ref)
    haps = [haplotype(ref, variants, h) for h in (1, 2)]
    fasta = formats.write_fasta(os.path.join(out_dir, "ref.fa"), contig,
                                ref.tobytes())
    sv_min = int(spec.get("params", {}).get("phase", {}).get(
        "indelSizeForSVHandling", 50))
    rows = []
    for v in variants:
        big = max(len(v.ref), len(v.alt)) - 1 >= sv_min
        info = ("." if not big else
                f"SVTYPE={'INS' if v.kind == 'ins' else 'DEL'}")
        rows.append((v.pos, v.ref, v.alt, info))
    vcf = formats.write_vcf(os.path.join(out_dir, "calls.vcf"), contig, L,
                            rows)
    records, read_hap, total = _reads(rng, spec, haps, spec["coverage"] * L,
                                      names_hap=True)
    bam = formats.write_bam(os.path.join(out_dir, "reads.bam"), contig, L,
                            records)
    params = os.path.join(out_dir, "params.json")
    with open(params, "w") as fh:
        json.dump(params_json(rng, spec), fh)
    return Dataset("phase", contig, L, bam, fasta, params, vcf=vcf,
                   variants=variants, read_hap=read_hap,
                   n_reads=len(records), read_bases=total)


# ---------------------------------------------------------------------------
# margin polish
# ---------------------------------------------------------------------------

def draft_from_truth(rng, spec, truth: np.ndarray):
    """The draft: the truth with substitutions and 1-3 bp insertions and
    deletions every spec["draft_error_every"] bases, a
    spec["homopolymer_bias"] share of the sites in runs of 3 or more,
    sites at least 12 bases apart, kinds 40/30/30 as a shuffled fixed
    multiset. Returns (draft, the edits that turn the draft back into the
    truth, as Variants in draft coordinates)."""
    L = len(truth)
    run_start = np.concatenate([[True], truth[1:] != truth[:-1]])
    run_id = np.cumsum(run_start) - 1
    run_len = np.bincount(run_id)[run_id]
    in_runs = np.nonzero(run_len >= 3)[0]
    n_err = max(1, L // int(spec["draft_error_every"]))
    occupied = np.zeros(L + 24, dtype=bool)
    sites = []
    while len(sites) < n_err:
        if len(in_runs) and rng.random() < spec["homopolymer_bias"]:
            t = int(in_runs[rng.integers(0, len(in_runs))])
        else:
            t = int(rng.integers(0, L))
        if 20 <= t < L - 20 and not occupied[t + 12]:
            sites.append(t)
            occupied[t + 1:t + 24] = True
    n_snv, n_ins = int(round(0.4 * n_err)), int(round(0.3 * n_err))
    kinds = np.array(["snv"] * n_snv + ["ins"] * n_ins
                     + ["del"] * (n_err - n_snv - n_ins))[rng.permutation(n_err)]
    pieces, edits = [], []
    cur = dlen = 0
    for t, kind in zip(sorted(sites), kinds):
        pieces.append(truth[cur:t])
        dlen += t - cur
        n = int(rng.integers(1, 4))
        b = truth[t]
        if kind == "snv":
            alt = _other_base(rng, b)
            pieces.append(np.array([alt], np.uint8))
            edits.append(Variant(dlen, chr(alt), chr(b), 1, "snv"))
            dlen, cur = dlen + 1, t + 1
        elif kind == "ins":
            extra = (np.full(n, b, np.uint8) if run_len[t] >= 3
                     else _BASES[rng.integers(0, 4, n)])
            ref = np.concatenate([[b], extra]).astype(np.uint8)
            pieces.append(ref)
            edits.append(Variant(dlen, ref.tobytes().decode(), chr(b), 1,
                                 "del"))
            dlen, cur = dlen + len(ref), t + 1
        else:
            alt = truth[t:t + n + 1]
            pieces.append(np.array([b], np.uint8))
            edits.append(Variant(dlen, chr(b), alt.tobytes().decode(), 1,
                                 "ins"))
            dlen, cur = dlen + 1, t + n + 1
    pieces.append(truth[cur:])
    return np.concatenate(pieces).astype(np.uint8), edits


def _polish_set(out_dir: str, spec: dict, rng) -> Dataset:
    contig, L = spec.get("contig", "contig1"), int(spec["contig_len"])
    truth = _BASES[rng.integers(0, 4, L)]
    draft, edits = draft_from_truth(rng, spec, truth)
    hap = haplotype(draft, edits, 1)
    if not np.array_equal(hap[0], truth):
        raise AssertionError("the draft's edits do not give the truth back")
    fasta = formats.write_fasta(os.path.join(out_dir, "draft.fa"), contig,
                                draft.tobytes())
    records, _, total = _reads(rng, dict(spec, overhang=True), [hap],
                               spec["coverage"] * L, names_hap=False)
    bam = formats.write_bam(os.path.join(out_dir, "reads.bam"), contig,
                            len(draft), records)
    params = os.path.join(out_dir, "params.json")
    with open(params, "w") as fh:
        json.dump(params_json(rng, spec), fh)
    return Dataset("polish", contig, len(draft), bam, fasta, params,
                   variants=edits, truth=truth.tobytes(), truth_map=hap[1],
                   n_reads=len(records), read_bases=total)


def generate(out_dir: str, kind: str, spec: dict, seed: int) -> Dataset:
    """Write the input set of a `phase` or `polish` cell under out_dir:
    the same seed and spec give the same files, byte for byte."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(int(seed))
    if kind == "phase":
        return _phase_set(out_dir, spec, rng)
    if kind == "polish":
        return _polish_set(out_dir, spec, rng)
    raise ValueError(f"no generator for {kind!r}")
