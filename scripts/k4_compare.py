#!/usr/bin/env python3
"""Time K4 (K2-bwd's EXP instance) beside K2-bwd POST on one pack of band
width 128, from the checkout at --root, on a CUDA device.

    python3 scripts/k4_compare.py --root DIR [--label NAME] [--reps 5]

Imports margin_tpu_torch from DIR (building its kernels there at first
use), packs 39 seeded problems of 500-1800 bases anchored every 6 bases
(a band of ~110 cells, the W = 128 bucket, as the phase path's K2 packs),
runs K2-fwd once under the LUT, then times K4 (fb_expectations) and K2-bwd
POST (fb_backward) on its grid: the median of --reps CUDA-event timed
calls after a warm-up, each call with its wrapper's host work. Prints one
JSON line: label, root, the pack's shape, both times, ns a diagonal of the
deepest problem and K4 / POST. Run it on two checkouts in one process
order (parent, change, change, parent) to compare them on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys


def cuda_ms(fn, reps):
    import torch
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


def pack_of(device, n=39, exp=100, seed=7):
    import numpy as np
    from margin_tpu_torch.ops import banded, cuda_banded, pairhmm
    from margin_tpu_torch.params import StateMachineParams
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        lx = int(rng.integers(500, 1801))
        x = rng.integers(0, 4, lx).astype(np.int32)
        y = x.copy()
        flip = rng.random(lx) < 0.08
        y[flip] = (y[flip] + rng.integers(1, 4, int(flip.sum()))) % 4
        keep = rng.random(lx) > 0.04
        ypos = np.cumsum(keep) - 1
        xa = np.nonzero(keep)[0][::6][1:-1]
        items.append({"x_sym": x, "y_sym": y[keep], "strand": i % 2,
                      "anchors": [(int(a), int(ypos[a]), exp) for a in xa]})
    geoms = [banded._item_geom(it, exp, False) for it in items]
    w = banded._bucket_w(max(g.w_pad for g in geoms))
    tabs = pairhmm.PairHmmTables.from_params(
        StateMachineParams.default_nucleotide(), device=device)
    return cuda_banded._pack_host(tabs, items, w, exp, False, False, geoms,
                                  device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from margin_tpu_torch.ops import cuda_banded
    pack = pack_of("cuda")
    deepest = max(g.lx + g.ly + 1 for g in pack.geoms)
    fwd, totals = cuda_banded.fb_forward(pack, True)
    k4 = cuda_ms(lambda: cuda_banded.fb_expectations(pack, fwd, totals,
                                                     True), args.reps)
    post = cuda_ms(lambda: cuda_banded.fb_backward(pack, fwd, totals, True),
                   args.reps)
    print(json.dumps({
        "label": args.label or root, "root": root,
        "module": os.path.dirname(cuda_banded.__file__),
        "pack": {"B": pack.B, "rows": pack.n_rows, "W": pack.W,
                 "deepest_diagonals": deepest},
        "k4_ms": k4, "post_ms": post, "k4_ns_per_diagonal": k4 * 1e6 / deepest,
        "k4_over_post": k4 / post}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
