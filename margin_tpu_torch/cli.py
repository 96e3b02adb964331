"""Command line interface: `python -m margin_tpu_torch phase|polish ...`.

Counterpart of `margin_tpu/cli.py` (margin.c dispatch + phase.c/polish.c
argument handling): the common flags, the `phase` subcommand, the
`polish` subcommand (haploid and `--diploid`, with VCF-guided polish,
the supplementary outputs and the HELEN features), the aux tools
(`calcLocalPhasingCorrectness`, `tagFromIds`, `tagFromPhasedVcf`,
`runLengthMatrix`) and `--device {cuda,cpu}`, which takes the place of
JAX_PLATFORMS. `--workers process`, `--hosts`/`--host-id`/`--coordinator`
and `--jaxTrace` are not ported yet and stop with an error naming their
ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys

_SCALE = "IPC workers, multi-GPU and multi-host"


def _add_polish(po):
    """The polish flags of margin_tpu/cli.py:110-156 that this package
    runs."""
    po.add_argument("-2", "--diploid", action="store_true")
    po.add_argument("-v", "--vcf", default=None,
                    help="VCF with variants for diploid phasing")
    po.add_argument("-A", "--onlyVcfAlleles", action="store_true",
                    help="only consider alleles from the VCF (requires "
                         "non-RLE params and --skipOutputFasta)")
    po.add_argument("-T", "--skipOutputFasta", action="store_true",
                    help="skip consensus FASTA output (diploid: only the "
                         "haplotagged BAM and ancillary files are written)")
    po.add_argument("-S", "--skipFilteredReads", action="store_true",
                    help="do NOT haplotype filtered reads (--diploid only; "
                         "polish.c:51)")
    po.add_argument("-R", "--skipRealignment", action="store_true",
                    help="fill the POA from CIGAR likelihoods only, no DP "
                         "realignment (--diploid haplotyping; polish.c:52)")
    po.add_argument("-M", "--skipHaplotypeBAM", action="store_true",
                    help="do not write the haplotagged BAM (--diploid only)")
    po.add_argument("-i", "--outputRepeatCounts", action="store_true",
                    help="write per-chunk repeat count observations as CSV")
    po.add_argument("-j", "--outputPoaCsv", action="store_true",
                    help="write per-chunk POA as CSV")
    po.add_argument("-d", "--outputPoaDot", action="store_true",
                    help="write per-chunk POA as DOT")
    po.add_argument("-n", "--outputHaplotypeReads", action="store_true",
                    help="write phased reads and likelihoods as CSV "
                         "(--diploid only)")
    po.add_argument("-s", "--outputPhasingState", action="store_true",
                    help="write phasing likelihoods as JSON (--diploid only)")
    # HELEN feature export (polish.c:148-151, 195-219)
    po.add_argument("-f", "--produceFeatures", action="store_true",
                    help="output HELEN features (default type splitRleWeight)")
    po.add_argument("-F", "--featureType", default=None,
                    help="simpleWeight | splitRleWeight | channelRleWeight")
    po.add_argument("-L", "--splitRleWeightMaxRL", type=int, default=0,
                    help="max run length for RLE feature types [default 10]")
    po.add_argument("-u", "--trueReferenceBam", default=None,
                    help="truth assembly aligned to the reference, for "
                         "HELEN feature labels (and, --diploid, the truth "
                         "haplotypes' partition)")
    po.add_argument("--fullFeatureOutput", action="store_true",
                    help="also write per-chunk consensus FASTAs")


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

    # aux tool dispatch (tools/ executables in the reference)
    if argv and argv[0] == "calcLocalPhasingCorrectness":
        from margin_tpu_torch.tools.lpc import main as lpc_main
        return lpc_main(argv[1:])
    if argv and argv[0] == "tagFromIds":
        from margin_tpu_torch.tools.tag_from_ids import main as tfi_main
        return tfi_main(argv[1:])
    if argv and argv[0] == "tagFromPhasedVcf":
        from margin_tpu_torch.tools.tag_from_phased_vcf import \
            main as tfpv_main
        return tfpv_main(argv[1:])
    if argv and argv[0] == "runLengthMatrix":
        from margin_tpu_torch.tools.run_length_matrix import main as rlm_main
        return rlm_main(argv[1:])


    top = argparse.ArgumentParser(prog="margin_tpu_torch",
                                  description="margin phase on PyTorch/CUDA")
    sub = top.add_subparsers(dest="command", required=True)
    ph = sub.add_parser("phase", help="haplotag reads / phase a VCF")
    _add_common(ph)
    ph.add_argument("vcf", help="VCF with variants to phase")
    ph.add_argument("-M", "--skipHaplotypeBAM", action="store_true")
    ph.add_argument("-V", "--skipPhasedVCF", action="store_true")
    po = sub.add_parser("polish", help="polish an assembly")
    _add_common(po)
    _add_polish(po)

    args = top.parse_args(argv)

    if args.tempFilesToDisk:
        args.checkpoint = True
    if args.command == "phase" and args.skipHaplotypeBAM \
            and args.skipPhasedVCF:
        top.error("With --skipHaplotypeBAM and --skipPhasedVCF there "
                  "will be no output.")
    if args.command == "polish":
        if args.diploid and (args.checkpoint or args.shard is not None
                             or args.threads > 1):
            top.error("--checkpoint, --shard and -t of --diploid are not "
                      f"ported yet (ROADMAP queue 1, \"{_SCALE}\")")
    if args.workers == "process" and args.threads > 1:
        top.error("--workers process is not ported yet (ROADMAP queue 1, "
                  f"\"{_SCALE}\")")
    if args.hosts is not None or args.host_id is not None \
            or args.coordinator is not None:
        top.error("--hosts/--host-id/--coordinator are not ported yet "
                  f"(ROADMAP queue 1, \"{_SCALE}\")")
    if args.jaxTrace is not None:
        top.error("--jaxTrace traces JAX, which this package does not use; "
                  "use --profile")
    for path, desc in [(args.bam, "bam"), (args.reference, "reference fasta"),
                       (args.params, "params")]:
        if not os.path.exists(path):
            top.error(f"Could not read from input {desc} file: {path}")
    if args.command == "polish":
        if args.vcf is not None and not os.path.exists(args.vcf):
            top.error(f"Could not read from vcf file: {args.vcf}")
        if args.onlyVcfAlleles and not args.skipOutputFasta:
            top.error("The --onlyVcfAlleles parameter must be used with "
                      "the --skipOutputFasta option")
        if args.skipOutputFasta and (args.outputPoaCsv
                                     or args.outputRepeatCounts
                                     or args.outputPoaDot):
            # polish.c:313-314
            top.error("Cannot --outputPoaCsv, --outputRepeatCounts, or "
                      "--outputPoaDot with --skipOutputFasta")
        # polish.c:216-219, 301-307: validate feature flags up front
        if args.splitRleWeightMaxRL < 0:
            top.error(f"Invalid splitRleWeightMaxRL: "
                      f"{args.splitRleWeightMaxRL}")
        if args.trueReferenceBam is not None:
            if not os.path.exists(args.trueReferenceBam):
                top.error("Could not read from truth file: "
                          f"{args.trueReferenceBam}")
            if not os.path.exists(args.trueReferenceBam + ".bai"):
                top.error("BAM does not appear to be indexed: "
                          f"{args.trueReferenceBam}")

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

    from margin_tpu_torch.utils import profiling
    profiler = profiling.Profiler(enabled=args.profile)
    if args.command == "phase":
        from margin_tpu_torch.phase.driver import run_phase
        run_phase(args.bam, args.reference, args.vcf, params,
                  args.outputBase, region=args.region,
                  write_bam=not args.skipHaplotypeBAM,
                  write_vcf=not args.skipPhasedVCF, seed=args.seed,
                  use_lut=args.lut_logadd, checkpoint=args.checkpoint,
                  shard=shard, profiler=profiler, rng_mode=args.rngMode,
                  threads=args.threads, device=args.device, log=log)
    else:
        from margin_tpu_torch.polish.driver import run_polish
        feature_type = args.featureType
        if feature_type is None and args.produceFeatures:
            feature_type = "splitRleWeight"  # polish.c:333-335
        run_polish(args.bam, args.reference, params, args.outputBase,
                   region=args.region, diploid=args.diploid, seed=args.seed,
                   use_lut=args.lut_logadd, feature_type=feature_type,
                   feature_max_rl=args.splitRleWeightMaxRL,
                   true_reference_bam=args.trueReferenceBam,
                   full_feature_output=args.fullFeatureOutput,
                   output_poa_csv=args.outputPoaCsv,
                   output_poa_dot=args.outputPoaDot,
                   output_repeat_counts=args.outputRepeatCounts,
                   output_haplotype_reads=args.outputHaplotypeReads,
                   output_phasing_state=args.outputPhasingState,
                   vcf_file=args.vcf,
                   only_use_vcf_alleles=args.onlyVcfAlleles,
                   skip_output_fasta=args.skipOutputFasta,
                   skip_filtered_reads=args.skipFilteredReads,
                   skip_realignment=args.skipRealignment,
                   skip_haplotype_bam=args.skipHaplotypeBAM,
                   checkpoint=args.checkpoint, shard=shard,
                   profiler=profiler, threads=args.threads,
                   device=args.device, log=log)
        profiler.log_summary(log)
    profiler.write(f"{args.outputBase}.profile.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
