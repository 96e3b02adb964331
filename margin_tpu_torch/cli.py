"""Command line interface: `python -m margin_tpu_torch phase ...`.

Counterpart of `margin_tpu/cli.py` (margin.c dispatch + phase.c argument
handling): the common flags, the `phase` subcommand and `--device
{cuda,cpu}`, which takes the place of JAX_PLATFORMS. `polish`, the aux
tools, `--workers process`, `--hosts`/`--host-id`/`--coordinator` and
`--jaxTrace` are not ported yet and stop with an error naming their
ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys

_AUX_TOOLS = ("calcLocalPhasingCorrectness", "tagFromIds",
              "tagFromPhasedVcf", "runLengthMatrix")


def _add_common(p):
    p.add_argument("bam", help="input BAM (indexed)")
    p.add_argument("reference", help="reference FASTA")
    p.add_argument("params", help="parameters JSON (margin-compatible)")
    p.add_argument("-o", "--outputBase", default="output",
                   help="output file prefix [default: output]")
    p.add_argument("-r", "--region", default=None,
                   help="region to process (contig or contig:start-end)")
    p.add_argument("-p", "--maxDepth", type=int, default=-1,
                   help="override maxDepth parameter")
    p.add_argument("--seed", type=int, default=0, help="random seed")
    p.add_argument("--lut-logadd", dest="lut_logadd", action="store_true",
                   default=True,
                   help="use the reference's piecewise-cubic LUT logAdd "
                        "(the default — same flavor as the reference "
                        "binary)")
    p.add_argument("--exact-logadd", dest="lut_logadd",
                   action="store_false",
                   help="use exact logaddexp instead of the LUT")
    p.add_argument("--checkpoint", action="store_true",
                   help="persist per-chunk results under "
                        "<outputBase>.checkpoint/ and resume a killed run")
    p.add_argument("--shard", default=None, metavar="I/N|merge",
                   help="multi-process scaling: 'I/N' processes every Nth "
                        "chunk (offset I) into the shared checkpoint dir; "
                        "'merge' combines all shards into final outputs")
    p.add_argument("-a", "--logLevel", default="INFO",
                   choices=["CRITICAL", "INFO", "DEBUG"],
                   help="logging verbosity [default: INFO]")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="host worker threads over chunks (phase.c -t); "
                        "each chunk then uses its own seeded RNG stream")
    p.add_argument("-k", "--tempFilesToDisk", action="store_true",
                   help="compatibility flag (polish.c -k): maps to "
                        "--checkpoint")
    p.add_argument("--workers", default="thread",
                   choices=["thread", "process"],
                   help="chunk worker kind for -t N ('process' is not "
                        "ported yet)")
    p.add_argument("--rngMode", default="st", choices=["st", "python"],
                   help="random stream: 'st' replays the reference "
                        "binary's glibc rand() stream exactly; 'python' "
                        "uses random.Random(seed)")
    p.add_argument("--hosts", type=int, default=None, metavar="N",
                   help="multi-host scale-out (not ported yet)")
    p.add_argument("--host-id", type=int, default=None, metavar="I",
                   help="this process's id in the --hosts group")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="coordinator address for --hosts")
    p.add_argument("--profile", action="store_true",
                   help="write structured per-chunk/per-stage timing to "
                        "<outputBase>.profile.json")
    p.add_argument("--jaxTrace", default=None, metavar="DIR",
                   help="not available in this package")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the scoring kernels run: 'cuda' (default) "
                        "launches the CUDA kernels, 'cpu' runs their "
                        "plain PyTorch twins")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in _AUX_TOOLS:
        sys.exit(f"margin_tpu_torch: {argv[0]} is not ported yet (ROADMAP "
                 "queue 1, \"HELEN, EM with K4, and the aux tools\")")

    top = argparse.ArgumentParser(prog="margin_tpu_torch",
                                  description="margin phase on PyTorch/CUDA")
    sub = top.add_subparsers(dest="command", required=True)
    ph = sub.add_parser("phase", help="haplotag reads / phase a VCF")
    _add_common(ph)
    ph.add_argument("vcf", help="VCF with variants to phase")
    ph.add_argument("-M", "--skipHaplotypeBAM", action="store_true")
    ph.add_argument("-V", "--skipPhasedVCF", action="store_true")
    sub.add_parser("polish", help="polish an assembly (not ported yet)",
                   add_help=False)

    if argv and argv[0] == "polish":
        top.exit(2, "margin_tpu_torch: polish is not ported yet (ROADMAP "
                 "queue 1, \"slice 2, haploid polish\")\n")
    args = top.parse_args(argv)

    if args.tempFilesToDisk:
        args.checkpoint = True
    if args.skipHaplotypeBAM and args.skipPhasedVCF:
        top.error("With --skipHaplotypeBAM and --skipPhasedVCF there "
                  "will be no output.")
    if args.workers == "process" and args.threads > 1:
        top.error("--workers process is not ported yet (ROADMAP queue 1, "
                  "\"IPC workers, multi-GPU and multi-host\")")
    if args.hosts is not None or args.host_id is not None \
            or args.coordinator is not None:
        top.error("--hosts/--host-id/--coordinator are not ported yet "
                  "(ROADMAP queue 1, \"IPC workers, multi-GPU and "
                  "multi-host\")")
    if args.jaxTrace is not None:
        top.error("--jaxTrace traces JAX, which this package does not use; "
                  "use --profile")
    for path, desc in [(args.bam, "bam"), (args.reference, "reference fasta"),
                       (args.params, "params")]:
        if not os.path.exists(path):
            top.error(f"Could not read from input {desc} file: {path}")

    from margin_tpu_torch.params import Params
    params = Params.load(args.params)
    if args.maxDepth >= 0:
        params.polish.maxDepth = args.maxDepth

    shard = None
    if args.shard is not None:
        if args.shard == "merge":
            shard = ("merge",)
        else:
            try:
                i_s, n_s = args.shard.split("/")
                shard = (int(i_s), int(n_s))
            except ValueError:
                top.error(f"Invalid --shard (want I/N or merge): "
                          f"{args.shard}")

    # CRITICAL silences per-chunk progress lines (the reference's
    # --logLevel); DEBUG and INFO both print them here
    log = (lambda *a: None) if args.logLevel == "CRITICAL" else print

    from margin_tpu_torch.phase.driver import run_phase
    from margin_tpu_torch.utils import profiling
    profiler = profiling.Profiler(enabled=args.profile)
    run_phase(args.bam, args.reference, args.vcf, params, args.outputBase,
              region=args.region, write_bam=not args.skipHaplotypeBAM,
              write_vcf=not args.skipPhasedVCF, seed=args.seed,
              use_lut=args.lut_logadd, checkpoint=args.checkpoint,
              shard=shard, profiler=profiler, rng_mode=args.rngMode,
              threads=args.threads, device=args.device, log=log)
    profiler.write(f"{args.outputBase}.profile.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
