#!/usr/bin/env python3
"""Time one checkout's K1 (the pair-HMM forward kernel of margin_tpu_torch)
on the batches a chip_smoke.py run launched and on chip_smoke.py's K1
shapes.

    python3 scripts/k1_replay.py --root DIR --label NAME \\
        [--launches chiprun_out/k1_launches.json] [--reps 5]
    python3 scripts/k1_replay.py --compare A.json B.json [C.json ...]

margin_tpu_torch is imported from DIR: this checkout, or an unpacked copy
of another commit, so that two designs of the kernel are timed on one card
in one command (run them as parent, change, change, parent). Each launch
that chip_smoke.py's phase, polish and diploid runs recorded is rebuilt
with its batch shape, RLE state, logAdd and every pair's lx and ly, with
seeded random symbols and run lengths in place of the reads', and timed
alone: the median CUDA-event time of --reps launches after a warm-up. The
K1 shapes of chip_smoke.py (K1_SHAPES) are timed under both logAdds.
Writes chiprun_out/k1_replay_NAME.json beside this script's checkout: each
launch's and shape's ms and the SHA-1 of its output. --compare prints such
files side by side: per run the summed ms, in all and by padded Ly
(chip_smoke.K1_LY_BUCKETS), each shape's ms, and whether the outputs are
bit-identical to the first file's.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    """chip_smoke.py of this checkout (it imports the port lazily, so its
    helpers use whichever margin_tpu_torch is first on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(t) -> str:
    return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()


def launch_batch(pairhmm, launch, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    pairs = [(rng.integers(0, 4, a).astype(np.uint8),
              rng.integers(0, 4, b).astype(np.uint8))
             for a, b in zip(launch["lxs"], launch["lys"])]
    reps = ([(rng.integers(1, 12, a), rng.integers(1, 12, b))
             for a, b in zip(launch["lxs"], launch["lys"])]
            if launch["rle"] else None)
    return pairhmm.make_batch(pairs, strands=rng.integers(0, 2, len(pairs)),
                              rep_pairs=reps, device="cuda",
                              pad_to=(launch["Lx"], launch["Ly"]))


def timed(smoke, pairhmm, tabs, batch, lut, reps):
    """(ms, output digest), or (None, the error) where the kernel refuses
    the batch."""
    try:
        got = pairhmm.forward_total(tabs, batch, use_lut=lut)
        ms = smoke.cuda_ms(lambda: pairhmm.forward_total(tabs, batch, lut),
                           reps=reps)
    except (RuntimeError, ValueError) as e:
        return None, f"refused: {e}"
    return ms, digest(got)


def replay(args) -> int:
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("k1_replay: no CUDA device", file=sys.stderr)
        return 2
    from margin_tpu_torch.ops import pairhmm
    smoke = load_smoke()
    tabs = {rle: smoke.tables("cuda", rle) for rle in (False, True)}
    out = {"label": args.label, "root": os.path.abspath(args.root),
           "card": smoke.card_line(), "runs": {}, "shapes": []}
    print(f"{args.label}: {out['card']}; margin_tpu_torch from "
          f"{out['root']}", flush=True)
    if args.launches:
        with open(args.launches) as fh:
            runs = json.load(fh)
        for run, launches in runs.items():
            rows = []
            for i, l in enumerate(launches):
                batch = launch_batch(pairhmm, l, seed=i)
                ms, sha = timed(smoke, pairhmm, tabs[l["rle"]], batch,
                                l["lut"], args.reps)
                rows.append({"B": l["B"], "Lx": l["Lx"], "Ly": l["Ly"],
                             "ms": ms, "sha1": sha})
            out["runs"][run] = rows
            print(f"{args.label} {run}: {len(rows)} launches, "
                  f"{sum(r['ms'] or 0.0 for r in rows):.4f} ms summed",
                  flush=True)
    for label, B, lxr, lyr, rle, seed, first, pad_to in smoke.K1_SHAPES:
        batch = smoke.k1_batch("cuda", B, lxr, lyr, seed=seed, rle=rle,
                               first=first, pad_to=pad_to)
        for lut in (True, False):
            ms, sha = timed(smoke, pairhmm, tabs[rle], batch, lut, args.reps)
            out["shapes"].append({"shape": label, "lut": lut, "ms": ms,
                                  "sha1": sha})
            print(f"{args.label} K1 {label} {'LUT' if lut else 'exact'}: "
                  f"{ms if ms is None else round(ms, 4)} ms", flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    path = os.path.join(HERE, "chiprun_out", f"k1_replay_{args.label}.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {path}")
    return 0


def compare(paths) -> int:
    smoke = load_smoke()
    docs = []
    for p in paths:
        with open(p) as fh:
            docs.append(json.load(fh))
    names = [d["label"] for d in docs]
    print("card: " + "; ".join(f"{d['label']} {d['card']}" for d in docs))
    first = docs[0]
    for run in first["runs"]:
        ranges = [("all", 0, 1 << 30)] + [
            (f"Ly {lo}..{hi}", lo, hi) for lo, hi in smoke.K1_LY_BUCKETS]
        for name, lo, hi in ranges:
            cells = []
            for d in docs:
                sel = [r for r in d["runs"][run] if lo <= r["Ly"] <= hi]
                if not sel:
                    break
                cells.append(f"{d['label']} "
                             f"{sum(r['ms'] or 0.0 for r in sel):.4f}")
            if cells:
                print(f"{run} {name} ({len(sel)} launches), summed ms: "
                      + ", ".join(cells))
        same = [all(a["sha1"] == b["sha1"]
                    for a, b in zip(first["runs"][run], d["runs"][run]))
                for d in docs[1:]]
        print(f"{run}: outputs identical to {names[0]}'s: "
              + ", ".join(f"{n} {s}" for n, s in zip(names[1:], same)))
    for i, row in enumerate(first["shapes"]):
        cells = [f"{d['label']} {d['shapes'][i]['ms']}" for d in docs]
        same = all(d["shapes"][i]["sha1"] == row["sha1"] for d in docs)
        print(f"K1 {row['shape']} {'LUT' if row['lut'] else 'exact'} ms: "
              + ", ".join(cells) + f"; outputs identical: {same}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this")
    ap.add_argument("--launches")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--compare", nargs="+")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(args.compare)
    return replay(args)


if __name__ == "__main__":
    sys.exit(main())
