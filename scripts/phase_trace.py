#!/usr/bin/env python3
"""Trace one checkout's `margin phase` (margin_tpu_torch) on chip_smoke.py's
1 Mb synthetic contig under torch.profiler, on one NVIDIA GPU.

    python3 scripts/phase_trace.py --root DIR --label NAME [--work DIR]
                                   [--clean]
    python3 scripts/phase_trace.py --compare A.json B.json [C.json ...]

margin_tpu_torch is imported from DIR: this checkout, or an unpacked copy
of another commit, so that two versions are traced on one card in one
command (run them as parent, change, change, parent, sharing --work). The
phase set is chip_smoke.phase_dataset's (seed 7), written into --work on
the first run and reused by the next (--clean removes it at the end of a
run; the default --work is under the temporary directory). Each run
builds the checkout's kernels and engines (chip_smoke.phase_build), runs
`phase` once untraced
(its wall, and the warm-up), then once under torch.profiler with CPU and
CUDA activities (chip_smoke.traced): the device's busy time and share of
the run, the device time by kernel, and the host and device time of the
extraction (extract_packed's torch ops, where the checkout has them) or of
K2-bwd's WORDS instance (fb_backward_words, its launch and its read of the
count). Writes chiprun_out/phase_trace_NAME.json beside this script's
checkout, with the SHA-1 of the phased VCF and phaseset.bed; --compare
prints such files side by side and whether their outputs are identical.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    """chip_smoke.py of this checkout (it imports the port lazily, so its
    helpers use whichever margin_tpu_torch is first on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sha1(path):
    with open(path, "rb") as fh:
        return hashlib.sha1(fh.read()).hexdigest()


def dataset(smoke, work):
    """(bam, fasta, params, vcf) of the phase set in work, written on the
    first call."""
    index = os.path.join(work, "phase_set.json")
    if not os.path.exists(index):
        ds = smoke.phase_dataset(work)
        with open(index, "w") as fh:
            json.dump([ds.bam, ds.fasta, ds.params, ds.vcf], fh)
    with open(index) as fh:
        return json.load(fh)


def trace(args) -> int:
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("phase_trace: no CUDA device", file=sys.stderr)
        return 2
    smoke = load_smoke()
    os.makedirs(args.work, exist_ok=True)
    card = smoke.card_line()
    build = smoke.phase_build()
    common = dataset(smoke, args.work) + ["--device", "cuda"]
    log_path = os.path.join(args.work, f"{args.label}.log")
    base = os.path.join(args.work, args.label)
    wall = smoke.run_cli(["phase"] + common + ["-o", f"{base}_plain", "-a",
                                               "CRITICAL"], log_path)
    secs, summary = smoke.traced(
        lambda: smoke.run_cli(["phase"] + common + [
            "-o", f"{base}_traced", "-a", "CRITICAL"], log_path),
        f"{base}_trace.json")
    smoke.log_trace(f"{args.label} phase 1 Mb", summary)
    os.unlink(f"{base}_trace.json")
    out = {"label": args.label, "root": os.path.abspath(args.root),
           "card": card, "build_s": build["build_s"], "wall_s": wall,
           "traced_wall_s": secs, "trace": summary,
           "outputs": {ext: sha1(f"{base}_{run}.{ext}")
                       for run in ("plain", "traced")
                       for ext in ("phased.vcf", "phaseset.bed")}}
    smoke.log(f"{args.label}: card {card}; phase wall {wall:.2f} s "
              f"untraced, {secs:.2f} s traced")
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"phase_trace_{args.label}.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    if args.clean:
        shutil.rmtree(args.work, ignore_errors=True)
    return 0


def compare(paths) -> int:
    runs = []
    for p in paths:
        with open(p) as fh:
            runs.append(json.load(fh))
    first = runs[0]["outputs"]
    for r in runs:
        t = r["trace"]
        spans = {n: (round(v["host_ms"], 1), round(v["device_ms"], 2))
                 for n, v in t["spans"].items()}
        print(f"{r['label']}: wall {r['wall_s']:.2f} s (traced "
              f"{r['traced_wall_s']:.2f}); device busy {t['busy_s']} s, "
              f"share of the traced wall {t['busy_share_of_wall']}; spans "
              f"(host ms, device ms) {spans}; outputs "
              f"{'identical to' if r['outputs'] == first else 'DIFFER from'}"
              f" {runs[0]['label']}'s")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="change")
    ap.add_argument("--work", default=os.path.join(tempfile.gettempdir(),
                                                   "margin_phase_trace"))
    ap.add_argument("--clean", action="store_true")
    ap.add_argument("--compare", nargs="+", default=None)
    args = ap.parse_args(argv)
    if args.compare:
        return compare(args.compare)
    return trace(args)


if __name__ == "__main__":
    sys.exit(main())
