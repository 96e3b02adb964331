"""The comparison that decides `correct`, and the launch counts of the
rooflines.

Kernel outputs: a seeded sample of what the window's K1 launches and
banded-seam items returned, held to the plain reference
(`reference/pairhmm.py`, float64 on the run's device) on the same
inputs, with the tables worked out again from the params file:

  k1_total_gap      max over the sampled pairs of |program - reference|
                    total log-probability, over max(1, |reference|);
  banded_total_gap  the same of the banded items' totals;
  k2_post_gap,      per route (K2, K3, the host engine), the largest over
  k3_post_gap,      the sampled items of the posterior mass the program
  host_post_gap     misplaces: the sum over the reference's cells above
                    the threshold and the program's cells of |program -
                    reference| (a cell the program left out counts by how
                    far the reference's value exceeds the threshold), over
                    the reference's mass above the threshold.

Pipeline outputs, of every call of the window, held to the generator's
truth:

  haplotag_error    phase: the share of tagged reads whose HP tag
                    disagrees with their haplotype of origin (the better
                    of the two labellings), worst call;
  phase_error       phase: the share of phased true het sites whose phase
                    disagrees with the majority of their phase set, worst
                    call;
  unphased_share    phase: the share of true het sites left unphased;
  polish_residual   polish: edit distance of the polished region to the
                    truth over the draft's, worst call.

The kernel-level numbers follow the program's own inputs to its launches
(read substrings, alleles, anchors); the stages that made them are
held by the pipeline numbers.
"""

from __future__ import annotations

import json
import sys
from typing import Dict

import numpy as np

from portbench import roofline, truth
from portbench.reference import hmm, pairhmm as ref

K1_PAIRS_PER_LAUNCH = 24


def _gap(p: float, r: float) -> float:
    return abs(p - r) / max(1.0, abs(r))


def post_gap(rows, result: "ref.BandedResult", b: int, threshold: float,
             scale: float) -> float:
    """The posterior mass a result misplaces against the reference's item
    b: rows (matches, gap X, gap Y) of (value x scale, x - 1, y - 1).
    None where neither side has a cell above the threshold (a caller
    that asks for totals only sets it above 1)."""
    num = den = 0.0
    sel = result.selected(b, threshold)
    for s in range(3):
        mine = np.asarray(rows[s], np.float64).reshape(-1, 3)
        r_sel = sel[s]
        den += float(r_sel[:, 0].sum())
        if len(mine):
            p = mine[:, 0] / scale
            r = result.lookup(b, s, mine[:, 1].astype(np.int64) + 1,
                              mine[:, 2].astype(np.int64) + 1)
            num += float(np.abs(p - r).sum())
        have = {(int(x), int(y)) for x, y in mine[:, 1:3]}
        miss = [v for v, x, y in r_sel if (int(x), int(y)) not in have]
        num += float(np.maximum(np.asarray(miss) - threshold, 0).sum())
    if den > 0:
        return num / den
    return num if num > 0 else None


def k1_pairs(sampler, seed: int):
    """The sampled launches' pairs, K1_PAIRS_PER_LAUNCH a launch (the
    deepest among them): (pair dicts, program totals, LUT flags)."""
    rng = np.random.default_rng([seed, 23])
    pairs, prog, luts = [], [], []
    for batch, out, lut in sampler.k1.items:
        lxs = batch.lxs.cpu().numpy()
        lys = batch.lys.cpu().numpy()
        B = len(lxs)
        pick = set(rng.choice(B, size=min(B, K1_PAIRS_PER_LAUNCH - 1),
                              replace=False).tolist())
        pick.add(int(np.argmax(lxs + lys)))
        xs, ys = batch.xs.cpu().numpy(), batch.ys.cpu().numpy()
        st = batch.strands.cpu().numpy()
        rl = batch.ragged_left.cpu().numpy()
        rr = batch.ragged_right.cpu().numpy()
        rx = None if batch.rep_x is None else batch.rep_x.cpu().numpy()
        ry = None if batch.rep_y is None else batch.rep_y.cpu().numpy()
        o = out.float().cpu().numpy()
        for i in sorted(pick):
            p = {"x": xs[i, :lxs[i]], "y": ys[i, :lys[i]],
                 "strand": int(st[i]), "ragged_left": bool(rl[i]),
                 "ragged_right": bool(rr[i])}
            if rx is not None:
                p["rep_x"], p["rep_y"] = rx[i, :lxs[i]], ry[i, :lys[i]]
            pairs.append(p)
            prog.append(float(o[i]))
            luts.append(lut)
    return pairs, np.asarray(prog), luts


def _tables(ds, rle: bool):
    with open(ds.params) as fh:
        doc = json.load(fh)
    tabs = hmm.tables_from_params(doc)
    if not rle:
        tabs.repeat = None
    return tabs


def _by_route(sample):
    """The sampled banded items grouped by (key, narrow or wide band),
    each with its route."""
    groups: Dict[tuple, list] = {}
    for it, res, key in sample:
        lx, ly = len(it["x_sym"]), len(it["y_sym"])
        if lx + ly == 0:
            continue
        expansion, _, _, dynamic, _ = key
        shape = roofline.ItemShape(lx, ly, ref.build_band(
            it.get("anchors"), lx, ly, expansion, dynamic))
        wide = shape.route == "host"
        groups.setdefault((key, wide), []).append((it, res, shape.route))
    return groups


def kernel_readings(ds, sampler, seed: int, device: str, dtype=None,
                    against=None) -> Dict[str, float]:
    """The kernel-level numbers of the sample. With `against` (a dtype),
    the reference computed in that precision takes the program's place:
    the control."""
    import torch
    dtype = torch.float64 if dtype is None else dtype
    out: Dict[str, float] = {}
    pairs, prog, luts = k1_pairs(sampler, seed)
    if pairs:
        gaps = []
        for lut in sorted(set(luts)):
            sel = [i for i, v in enumerate(luts) if v == lut]
            sub = [pairs[i] for i in sel]
            rle = sub[0].get("rep_x") is not None
            tabs = _tables(ds, rle)
            r = ref.dense_forward_totals(tabs, sub, lut, dtype, device)
            p = (prog[sel] if against is None else ref.dense_forward_totals(
                tabs, sub, lut, against, device))
            gaps += [_gap(a, b) for a, b in zip(p, r)]
        out["k1_total_gap"] = max(gaps)
    for (key, wide), group in _by_route(sampler.banded_sample()).items():
        expansion, threshold, lut, dynamic, rle = key
        tabs = _tables(ds, rle)
        items = [g[0] for g in group]
        result = ref.banded_posteriors(tabs, items, expansion, lut, dynamic,
                                       dtype, device)
        if against is not None:
            low = ref.banded_posteriors(tabs, items, expansion, lut, dynamic,
                                        against, device)
            progs = [(low.selected(b, threshold), float(low.totals[b]))
                     for b in range(len(items))]
            scale = 1.0
        else:
            progs = [g[1] for g in group]
            scale = 1e7
        for b, (it, res, route) in enumerate(group):
            rows, total = progs[b]
            name = f"{route}_post_gap"
            g = post_gap(rows, result, b, threshold, scale)
            if g is not None:
                out[name] = max(out.get(name, 0.0), g)
            out["banded_total_gap"] = max(out.get("banded_total_gap", 0.0),
                                          _gap(total, result.totals[b]))
        del result
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def pipeline_readings(cell, ds, calls) -> Dict[str, float]:
    out: Dict[str, float] = {}
    done = [c for c in calls if c.error is None]
    if cell.kind == "phase":
        for c in done:
            tags = truth.bam_haplotags(c.out_base + ".haplotagged.bam")
            err, _ = truth.haplotag_error(tags, ds.read_hap)
            sites = truth.phased_sites(c.out_base + ".phased.vcf")
            ph_err, unphased = truth.phase_error(sites, ds.variants,
                                                 *c.region)
            for k, v in (("haplotag_error", err), ("phase_error", ph_err),
                         ("unphased_share", unphased)):
                out[k] = max(out.get(k, 0.0), v)
        return out
    for c in done:
        lo, hi = c.region
        polished = truth.fasta_seq(c.out_base + ".fa")
        draft = truth.fasta_seq(ds.fasta)[lo:hi]
        want = ds.truth_segment(lo, hi)
        ed_pol = truth.banded_edit_distance(polished, want, 300)
        ed_draft = truth.banded_edit_distance(draft, want, 300)
        out["polish_residual"] = max(out.get("polish_residual", 0.0),
                                     ed_pol / max(ed_draft, 1))
    return out


def compare(cell, ds, calls, sampler, seed: int,
            device: str) -> Dict[str, float]:
    import time
    t = time.perf_counter()
    readings = kernel_readings(ds, sampler, seed, device)
    t1 = time.perf_counter()
    readings.update(pipeline_readings(cell, ds, calls))
    print(f"comparison: kernels {t1 - t:.2f} s, pipeline "
          f"{time.perf_counter() - t1:.2f} s", file=sys.stderr, flush=True)
    return readings


# ---------------------------------------------------------------------------
# the rooflines' counts
# ---------------------------------------------------------------------------

def launch_work(sampler, cell) -> Dict[str, dict]:
    """Operations, bytes and bound seconds of the window's K1 launches
    and of its banded items by kernel (K2-fwd + K2-bwd WORDS, K3-fwd +
    K3-bwd), and the items the host engine took."""
    work = {k: {"ops": 0.0, "bytes": 0.0, "launches": 0}
            for k in ("k1", "k2", "k3")}
    work["host"] = {"items": 0}
    for B, Lx, Ly, lxs, lys, rle, lut in sampler.k1_launches:
        ops, nb = roofline.k1_work(B, Lx, Ly, lxs.cpu().numpy(),
                                   lys.cpu().numpy(), lut, rle)
        w = work["k1"]
        w["ops"] += ops
        w["bytes"] += nb
        w["launches"] += 1
        w["pairs"] = w.get("pairs", 0) + B
    for lx, ly, anchors, has_rep, n_words, key in sampler.items:
        if lx + ly == 0:
            continue
        expansion, _, lut, dynamic, rle_tab = key
        shape = roofline.ItemShape(lx, ly, ref.build_band(
            anchors, lx, ly, expansion, dynamic))
        if shape.route == "host":
            work["host"]["items"] += 1
            continue
        rle = rle_tab and has_rep
        fn = roofline.k2_work if shape.route == "k2" else roofline.k3_work
        w = work[shape.route]
        for ops, nb in fn(shape, lut, rle, n_words):
            w["ops"] += ops
            w["bytes"] += nb
        w["launches"] += 1
    for w in (work["k1"], work["k2"], work["k3"]):
        w["bound_s"] = roofline.bound_s(w["ops"], w["bytes"])
    return work
