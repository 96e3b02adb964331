"""Run one cell of the benchmark of `margin_tpu_torch` once and print its
result as one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (building or loading the kernels and host engines, generating the
cell's inputs from the seed, one warm-up call) is timed as `setup_s`;
then the cell's entry (`margin phase` or `margin polish` on one region
at a time, regions in order and round the contig) runs until `--seconds`
have passed and the call in flight has returned. With `--trace 1` the
window runs under `torch.profiler` and the line carries the cell's
per-layer metrics instead of its end-to-end ones. The comparison that
decides `correct` runs after the window; each number it compares is
printed beside its limit as the last lines of standard error and under
the line's last key, `checks`.

Exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, and if jax, jaxlib, flax or margin_tpu was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# caches any library of the program would keep, at fixed paths inside the
# checkout (the program builds its own libraries into its _build folder)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, os.path.join(ROOT, ".portbench_cache", _sub))
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"{cell.name} needs {cell.chips} CUDA device(s); "
                    f"{n} visible")
        return 3
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t_start=T0)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"modules that may not load here were loaded: {bad}")
        return 4
    readings = result.pop("_readings")
    harness.log("readings: " + json.dumps(readings, sort_keys=True))
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r} "
                    f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
