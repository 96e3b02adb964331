"""The SV pairs of a phase cell's window held to the plain reference of SV
allele support (`reference/svscore.py`): a seeded sample of the
totals-only banded items the window scored, with the k-mer anchors and
the total worked out again from the allele and the read substring alone.
Not part of a benchmark run.

    python3 -m portbench.svcheck --workload phase-ont.sv-rich \
        --seeds 1,2,3 --seconds <s> [--pairs 200] [--device cuda|cpu]

For each seed it runs the cell as `run.py` does (with the window given)
and prints one JSON line: the harness's readings and `sv_pairs`, the
sampled pairs: how many, how many the window scored, how many of the
program's anchors differ from the reference's, and the largest relative
gap of their totals, per route.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from typing import Dict, List

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import control  # noqa: E402


class PairSample(control._Fault):
    """Alters nothing: keeps a seeded sample of the window's totals-only
    banded items (the SV pairs) with the program's anchors and totals.
    Installed through the harness's fault hook so that it sees the window
    alone."""
    module, attr = "margin_tpu_torch.ops.banded", "banded_posteriors_many"

    def __init__(self, seed: int, k: int):
        from portbench import harness
        self.res = harness.Reservoir(np.random.default_rng([seed, 29]), k)

    def wrap(self, real):
        lock = threading.Lock()

        def banded_posteriors_many(tables, items, expansion, threshold=0.01,
                                   use_lut=False, dynamic=False):
            res = real(tables, items, expansion, threshold, use_lut, dynamic)
            if threshold <= 1.0 or dynamic:
                return res
            rle = tables.repeat is not None
            with lock:
                for it, (_rows, total) in zip(items, res):
                    def rec(it=it, total=total):
                        p = {"x": np.array(it["x_sym"], copy=True),
                             "y": np.array(it["y_sym"], copy=True),
                             "strand": int(it["strand"]),
                             "anchors": [tuple(int(v) for v in a)
                                         for a in it.get("anchors") or []],
                             "total": float(total), "lut": bool(use_lut),
                             "expansion": int(expansion)}
                        if rle and it.get("rep_x") is not None:
                            p["rep_x"] = np.array(it["rep_x"], copy=True)
                            p["rep_y"] = np.array(it["rep_y"], copy=True)
                        return p
                    self.res.offer(rec)
            return res
        return banded_posteriors_many


def pair_readings(ds, sample: List[dict], device: str) -> dict:
    """The sampled pairs against the reference: anchors from the pair
    alone compared exactly, totals by relative gap, per route."""
    import torch
    from portbench import check, roofline
    from portbench.reference import pairhmm as ref, svscore
    out = {"n": len(sample), "anchor_mismatches": 0, "routes": {},
           "total_gap": 0.0}
    groups: Dict[tuple, list] = {}
    for p in sample:
        mine = svscore.kmer_anchors(p["x"], p["y"], p["expansion"])
        if mine != p["anchors"]:
            out["anchor_mismatches"] += 1
        route = roofline.ItemShape(len(p["x"]), len(p["y"]), ref.build_band(
            p["anchors"], len(p["x"]), len(p["y"]), p["expansion"])).route
        groups.setdefault((p["lut"], p["expansion"],
                           p.get("rep_x") is not None), []).append(
                               (p, route))
    for (lut, expansion, rle), group in groups.items():
        tabs = check._tables(ds, rle)
        r = svscore.totals(tabs, [g[0] for g in group], expansion, lut,
                           torch.float64, device)
        for (p, route), want in zip(group, r):
            gap = check._gap(p["total"], float(want))
            s = out["routes"].setdefault(route, {"n": 0, "total_gap": 0.0})
            s["n"] += 1
            s["total_gap"] = max(s["total_gap"], gap)
            out["total_gap"] = max(out["total_gap"], gap)
    return out


def readings(cell, seeds, seconds: float, pairs: int = 200,
             device: str = "cuda"):
    """One dict a seed of the cell (a harness.Cell)."""
    from portbench import harness
    for seed in seeds:
        sample = PairSample(seed, pairs)

        def after(ds, sampler):
            got = pair_readings(ds, sample.res.items, device)
            got["seen"] = sample.res.n
            return got
        res = harness.run(cell, seed, seconds, False, device=device,
                          fault=sample, after=after)
        yield {"workload": cell.name, "seed": seed,
               "correct": res["correct"], "attempted": res["attempted"],
               "failed": res["failed"], "program": res["_readings"],
               "sv_pairs": res["_after"], "device": res["device"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--pairs", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from portbench import harness
    seeds = [int(s) for s in args.seeds.split(",")]
    for line in readings(harness.load_cell(args.workload), seeds,
                         args.seconds, args.pairs, args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
