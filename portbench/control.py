"""The readings that limits are set from: the program's, the control's
and the planted faults', on one cell at its own size, several seeds in
one process. Not part of a benchmark run.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--fault k1|banded] [--device cuda|cpu]

For each seed it runs the cell as `run.py` does (with the window given)
and prints one JSON line: the program's readings and, without --fault,
the control's: the plain reference computed in bfloat16, the precision
below the configuration's float32, put in the program's place on the
same sampled launches and items. With --fault the window runs with an
answer altered where it is produced: `k1` permutes the totals of every
K1 launch, `banded` lowers every banded total by 50 and moves every
posterior cell one read position on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class _Fault:
    module = attr = ""

    def install(self):
        import importlib
        self.mod = importlib.import_module(self.module)
        self.real = getattr(self.mod, self.attr)
        setattr(self.mod, self.attr, self.wrap(self.real))

    def uninstall(self):
        setattr(self.mod, self.attr, self.real)


class AlterK1(_Fault):
    """Every K1 launch returns its totals in a seeded permuted order."""
    module, attr = "margin_tpu_torch.ops.pairhmm", "forward_total"

    def wrap(self, real):
        import torch

        def forward_total(tables, batch, use_lut=False):
            out = real(tables, batch, use_lut)
            if out.numel() < 2:
                return out - 50.0
            g = torch.Generator().manual_seed(out.numel())
            return out[torch.randperm(out.numel(), generator=g).to(
                out.device)].contiguous()
        return forward_total


class AlterBanded(_Fault):
    """Every banded item's total lowered by 50 and its posterior cells
    moved one read position on."""
    module, attr = "margin_tpu_torch.ops.banded", "banded_posteriors_many"

    def wrap(self, real):
        def banded_posteriors_many(tables, items, expansion, threshold=0.01,
                                   use_lut=False, dynamic=False):
            res = real(tables, items, expansion, threshold, use_lut, dynamic)
            out = []
            for it, (rows, total) in zip(items, res):
                moved = []
                for r in rows:
                    r = r.copy()
                    r[:, 2] = (r[:, 2] + 1) % max(len(it["y_sym"]), 1)
                    moved.append(r)
                out.append((tuple(moved), total - 50.0))
            return out
        return banded_posteriors_many


FAULTS = {"k1": AlterK1, "banded": AlterBanded}


def readings(cell_name: str, seeds, seconds: float, fault: str = "",
             device: str = "cuda", overrides=None):
    """One dict a seed: the program's readings and the control's (or,
    with a fault, the faulted program's)."""
    import torch
    from portbench import check, harness
    cell = harness.load_cell(cell_name, overrides)

    def control(ds, sampler):
        return check.kernel_readings(ds, sampler, 0, device,
                                     against=torch.bfloat16)
    for seed in seeds:
        res = harness.run(cell, seed, seconds, False, device=device,
                          fault=FAULTS[fault]() if fault else None,
                          after=None if fault else control)
        yield {"workload": cell_name, "seed": seed, "fault": fault or None,
               "correct": res["correct"], "attempted": res["attempted"],
               "program": res["_readings"], "control": res.get("_after"),
               "device": res["device"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault", choices=sorted(FAULTS), default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for line in readings(args.workload, seeds, args.seconds, args.fault,
                         args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
