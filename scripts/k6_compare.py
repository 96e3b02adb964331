#!/usr/bin/env python3
"""Time K6 (the read-partition HMM's forward-backward) and its host pack,
from the checkout at --root, on a CUDA device.

    python3 scripts/k6_compare.py --root DIR [--label NAME] [--reps 5]

Imports margin_tpu_torch from DIR (building K6 there at first use) and
makes every input with the builders of this script's own checkout's
chip_smoke.py, so that two checkouts get the same inputs from the same
seeds: the cross product of work >= 10M (two read sets of
random_profile_seqs(31, 600, 220, (60, 150))), wide_site_pack (a
300-allele site, with the ancestor), random_pack at 20,000 merge slots
(merge rows too wide for a shared-memory carry) and at 1000 cells a
column and 2000 slots, and the merge tree of random_profile_seqs(5, 24,
44, (10, 23)) (get_rp_hmms of each half, merge_two_tiling_paths,
fuse_tiling_path, forward_backward), each of whose FBs is kept. On each
input: K6's time (the median of --reps CUDA-event timed calls after a
warm-up, the wrapper's host work included), each launch's device time
read from torch.profiler with k6_emissions and k6_chain apart (the
chain's ns a column, both sweeps), and, where an HMM is behind it, the
pack's ms (its first call on the HMM, then the median of --reps) and K6
with pack and read-back. Each FB of the merge tree gets its pack's ms and
K6's ms and device times; the tree is timed bare with
MARGIN_TPU_RPHMM=device and =host in turns. Prints one JSON line. Run it
on two checkouts in one call (parent, change, change, parent) to compare
them on one card; build_s is the build of K6's library there.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time


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


def host_ms(fn, reps):
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_us(fn, reps, tries=3):
    """Each K6 kernel's device microseconds a launch, by torch.profiler; a
    session that shows no K6 kernel is tried again, up to `tries` times,
    then both are None."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
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
    return {"k6_emissions": None, "k6_chain": None}


def cross_product(chip_smoke, rphmm, rphmm_device, PhaseParams):
    bref, seqs = chip_smoke.random_profile_seqs(31, 600, 220, (60, 150))
    params = PhaseParams()
    tp1 = rphmm.get_rp_hmms(seqs[0::2], bref, params, "cuda")
    tp2 = rphmm.get_rp_hmms(seqs[1::2], bref, params, "cuda")
    crosses = []
    for comp in rphmm.get_overlapping_components(tp1, tp2):
        sub = rphmm.get_tiling_paths(comp)
        if len(sub) == 2:
            h1 = rphmm.fuse_tiling_path(sub[0])
            h2 = rphmm.fuse_tiling_path(sub[1])
            rphmm.RPHmm.align_columns(h1, h2)
            crosses.append(rphmm.RPHmm.cross_product(h1, h2))
    return max(crosses, key=rphmm_device.work)


def k6_row(rphmm_fb, pk, include_ancestor, reps):
    """K6 on one pack: held against its twin, then timed."""
    import torch
    got = rphmm_fb.rphmm_fb(pk, include_ancestor)
    want = rphmm_fb.rphmm_fb_plain(pk, include_ancestor)
    torch.cuda.synchronize()
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    fn = lambda: rphmm_fb.rphmm_fb(pk, include_ancestor)  # noqa: E731
    ms = cuda_ms(fn, reps)
    dev = device_us(fn, reps)
    ncol = pk.parts.shape[0]
    return {"dims": list(pk.dims), "include_ancestor": include_ancestor,
            "identical_to_twin": same, "k6_ms": ms,
            "emissions_us": dev["k6_emissions"], "chain_us": dev["k6_chain"],
            "chain_ns_per_column": (None if dev["k6_chain"] is None
                                    else dev["k6_chain"] * 1e3 / ncol)}


def fb_row(rphmm_fb, rphmm_device, hmm, include_ancestor, reps):
    """One merge-tree FB: its pack's ms (the median of reps after a warm
    call) and K6's ms and device times on that pack."""
    pack_ms = host_ms(lambda: rphmm_device.pack(hmm, "cuda"), reps + 1)
    pk = rphmm_device.pack(hmm, "cuda")
    fn = lambda: rphmm_fb.rphmm_fb(pk, include_ancestor)  # noqa: E731
    dev = device_us(fn, reps)
    ncol, C = pk.parts.shape
    return {"work": rphmm_device.work(hmm), "ancestor": include_ancestor,
            "columns": ncol, "cells": C, "pack_ms": pack_ms,
            "k6_ms": cuda_ms(fn, reps), "emissions_us": dev["k6_emissions"],
            "chain_us": dev["k6_chain"]}


def hmm_row(rphmm_fb, rphmm_device, hmm, include_ancestor, reps):
    """The pack (its first call on the HMM, then the median of reps) and
    K6 with pack and read-back, timed before K6 alone."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pk = rphmm_device.pack(hmm, "cuda")
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    pack_ms = host_ms(lambda: rphmm_device.pack(hmm, "cuda"), reps)
    e2e_ms = host_ms(
        lambda: rphmm_device.forward_backward_device(hmm, include_ancestor,
                                                     "cuda"), reps)
    row = k6_row(rphmm_fb, pk, include_ancestor, reps)
    row.update(work=rphmm_device.work(hmm), pack_first_ms=first,
               pack_ms=pack_ms, with_pack_and_read_back_ms=e2e_ms)
    return row


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
    # the input builders: this script's own chip_smoke.py, whatever the
    # checkout timed (they import margin_tpu_torch, DIR's, when called)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from margin_tpu_torch.ops import rphmm_fb
    from margin_tpu_torch.params import PhaseParams
    from margin_tpu_torch.phase import rphmm, rphmm_device
    saved = os.environ.get("MARGIN_TPU_RPHMM")
    out = {"label": args.label or root, "root": root,
           "module": os.path.dirname(rphmm_fb.__file__),
           "card": chip_smoke.card_line(), "inputs": {}}
    try:
        os.environ["MARGIN_TPU_RPHMM"] = "host"
        hmm = cross_product(chip_smoke, rphmm, rphmm_device, PhaseParams)
        out["inputs"]["cross product"] = hmm_row(rphmm_fb, rphmm_device, hmm,
                                                 False, args.reps)
        out["inputs"]["300-allele site"] = k6_row(
            rphmm_fb, chip_smoke.wide_site_pack("cuda"), True, args.reps)
        out["inputs"]["20,000 merge slots"] = k6_row(
            rphmm_fb, chip_smoke.random_pack("cuda"), False, args.reps)
        mid = chip_smoke.random_pack("cuda", C=1000, M=2000)
        for anc in (False, True):
            out["inputs"][f"1000 cells, ancestor {anc}"] = k6_row(
                rphmm_fb, mid, anc, args.reps)

        # the seeded merge tree: each FB's HMM kept, the largest timed
        ref, seqs = chip_smoke.random_profile_seqs(5, 24, 44, (10, 23))
        params = PhaseParams()
        real = rphmm_device.forward_backward_device
        fbs, largest = [], {}

        def keep(hmm, include_ancestor, dev):
            w = rphmm_device.work(hmm)
            fbs.append(fb_row(rphmm_fb, rphmm_device, hmm, include_ancestor,
                              args.reps))
            if w > largest.get("work", -1):
                largest.update(work=w, include_ancestor=include_ancestor,
                               pk=rphmm_device.pack(hmm, dev))
            return real(hmm, include_ancestor, dev)

        def tree(mode):
            os.environ["MARGIN_TPU_RPHMM"] = mode
            t0 = time.perf_counter()
            tf = rphmm.get_rp_hmms(seqs[0::2], ref, params, "cuda")
            tr = rphmm.get_rp_hmms(seqs[1::2], ref, params, "cuda")
            merged = rphmm.merge_two_tiling_paths(tf, tr,
                                                  include_ancestor=False)
            h = rphmm.fuse_tiling_path(merged)
            h.forward_backward(include_ancestor=True)
            path = h.forward_traceback()
            torch.cuda.synchronize()
            return time.perf_counter() - t0, path

        rphmm_device.forward_backward_device = keep
        try:
            tree("device")
        finally:
            rphmm_device.forward_backward_device = real
        row = k6_row(rphmm_fb, largest["pk"], largest["include_ancestor"],
                     args.reps)
        row["work"] = largest["work"]
        out["inputs"]["the merge tree's largest FB"] = row
        dev_s, host_s, paths = [], [], []
        for _ in range(3):
            s, p = tree("device")
            dev_s.append(s)
            paths.append(p)
            s, p = tree("host")
            host_s.append(s)
            paths.append(p)
        out["merge_tree"] = {
            "fbs": len(fbs), "per_fb": fbs,
            "pack_ms_sum": sum(f["pack_ms"] for f in fbs),
            "k6_ms_sum": sum(f["k6_ms"] for f in fbs),
            "device_s": dev_s, "host_s": host_s,
            "device_median_s": statistics.median(dev_s),
            "host_median_s": statistics.median(host_s),
            "same_traceback": all(p == paths[0] for p in paths)}
    finally:
        if saved is None:
            os.environ.pop("MARGIN_TPU_RPHMM", None)
        else:
            os.environ["MARGIN_TPU_RPHMM"] = saved
    from margin_tpu_torch import _ext
    out["build_s"] = _ext.BUILD_SECONDS.get("rphmm_fb")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
