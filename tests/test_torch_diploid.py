"""The port's diploid `margin polish` end to end against the JAX package.

One seeded synthetic set (margin_tpu_torch.testing.synth
.write_diploid_polish_dataset): a 2.4 kb draft made from haplotype 1 with
the draft edits of PolishSynthConfig, a second haplotype with a het SNV or
1-10 bp het indel every 150-250 bases (so each chunk phases several
bubbles), 14x of 0.5-1 kb reads drawn alternately from the two
haplotypes with the chip run's ~8% error model, chunks of 1300 bp with
150 bp boundaries: two chunks and one phased seam. The params set
polish.skipHaploidPolishingIfDiploid.

Each mode runs margin_tpu's run_polish with the LUT logAdd (in a
subprocess on its CPU path, the banded problems on its exact native
engine, MARGIN_TPU_NATIVE_SCAN_CELLS=1, XLA's FMA contraction off; see
tests/test_torch_pairhmm.py) and `margin_tpu_torch.cli.main --device cpu`
(in a subprocess, torch at one thread, the LUT logAdd by default), all at
once. The JAX side is called as a function because margin_tpu's CLI does
not pass its --lut-logadd on to run_polish, so its polish always runs the
exact logAdd. Every file the two write must be byte-identical: hap1.fa,
hap2.fa, the chunks CSV, the haplotagged BAM (both packages load marginio
with the system's libdeflate here) and the supplementary outputs, but for
the numbers of the POA CSV and DOT files (-j, -d). Those print node
weights to six decimals, and the weights differ by up to one unit of
1e-7 per read: exp() is the C library's in the JAX package's native
banded engine and PyTorch's in the port's twins, a last-bit float32
difference (ROADMAP queue 3, tests/test_torch_polish.py
::test_poa_realign_matches). Their text must be identical and each number
within 1e-6 (the print's rounding) plus 1e-7 per read. The modes: plain
--diploid; -v with the truth VCF; -v -A -T with run-length encoding off;
-i -j -d -n -s; -R -S -M (the POA from the CIGARs alone, no filtered-read
partition, no BAM). Two more subprocesses run chunk 0's diploid_chunk in
each package and keep its hap1/hap2 read names and the phased repeat
counts (estimate_phased_repeat_counts) of each hap POA's nodes, which
must agree.
"""

import importlib
import json
import os
import pickle
import random
import re
import struct
import subprocess
import sys

import pytest

from margin_tpu_torch.testing.synth import (DiploidPolishSynthConfig,
                                            write_diploid_polish_dataset)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CONFIG = DiploidPolishSynthConfig(
    contig_len=2400, coverage=14.0, read_len=(500, 1000),
    het_every=(150, 250), chunk_size=1300, chunk_boundary=150, seed=1)
# mode -> (the port's CLI flags, margin_tpu's run_polish arguments,
# params file); "{vcf}" is the dataset's truth VCF
MODES = {
    "plain": ([], {}, "params.json"),
    "vcf": (["-v", "{vcf}"], {"vcf_file": "{vcf}"}, "params.json"),
    "vcf_alleles_no_fasta": (
        ["-v", "{vcf}", "-A", "-T"],
        {"vcf_file": "{vcf}", "only_use_vcf_alleles": True,
         "skip_output_fasta": True}, "params_norle.json"),
    "outputs": (["-i", "-j", "-d", "-n", "-s"],
                {"output_repeat_counts": True, "output_poa_csv": True,
                 "output_poa_dot": True, "output_haplotype_reads": True,
                 "output_phasing_state": True}, "params.json"),
    "cigar_only_no_filtered_no_bam": (
        ["-R", "-S", "-M"],
        {"skip_realignment": True, "skip_filtered_reads": True,
         "skip_haplotype_bam": True}, "params.json"),
}


def _chunk0(pkg, d):
    """Chunk 0 of the plain mode through `pkg`'s diploid_chunk: (hap1
    names, hap2 names, per hap the phased repeat count of each POA node)."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    bamio, params_mod = mod("io.bam"), mod("params")
    params = params_mod.Params.load(f"{d}/params.json")
    pp = params.polish
    chunk = mod("phase.chunker").construct_chunker(
        f"{d}/reads.bam", None, None, pp, record_filtered_reads=True).chunks[0]
    raw = mod("io.fasta").FastaIndex(f"{d}/draft.fa").fetch(
        chunk.ref_name, chunk.chunk_overlap_start,
        chunk.chunk_overlap_end).upper()
    ref = mod("rle").RleString.encode(raw)
    reader = bamio.open_alignment(f"{d}/reads.bam")
    reads, alns, f_reads, f_alns = mod("polish.reads") \
        .convert_to_reads_and_alignments(chunk, ref, reader, pp,
                                         keep_filtered=True)
    reader.close()
    span = chunk.chunk_overlap_end - chunk.chunk_overlap_start
    # the driver would downsample above maxDepth; this set stays below it
    assert sum(r.rle_read.length for r in reads) / span < pp.maxDepth
    kw = {"device": "cpu"} if pkg == "margin_tpu_torch" else {}
    tables = mod("ops.pairhmm").PairHmmTables.from_params(
        pp.sm_forward, pp.sm_reverse, **kw)
    poa = mod("polish.poa").poa_realign(reads, alns, ref, pp, tables,
                                        use_lut=True)
    collect = {}
    mod("polish.diploid").diploid_chunk(
        poa, reads, f_reads, f_alns, ref, None, params, tables,
        ref_name=chunk.ref_name, use_lut=True, collect=collect,
        alignments=alns, chunk=chunk, rng=random.Random(0))
    pool = reads + collect["all_filtered"]
    names = [sorted({r.read_name for r in pool if id(r) in collect[k]})
             for k in ("hap1_ids", "hap2_ids")]
    counts = []
    for h in (1, 2):
        hp = collect[f"poa_hap{h}"]
        mod("polish.repeats").estimate_phased_repeat_counts(
            hp, reads, pp.repeat_sub_matrix, collect[f"hap{h}_ids"], pp)
        counts.append([n.repeat_count for n in hp.nodes[1:]])
    return names[0], names[1], counts


def run_side(side, d, mode):
    """Subprocess body: one package on one mode, into d/<mode>/<side>/out.*
    (margin_tpu's run_polish, the port's CLI), or for mode "chunk0"
    _chunk0 pickled to d/chunk0.<side>.pkl."""
    if side == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        pkg = "margin_tpu"
    else:
        import torch
        torch.set_num_threads(1)
        pkg = "margin_tpu_torch"
    if mode == "chunk0":
        with open(f"{d}/chunk0.{side}.pkl", "wb") as fh:
            pickle.dump(_chunk0(pkg, d), fh)
        return
    flags, kwargs, params = MODES[mode]
    vcf = f"{d}/calls.vcf"
    out = f"{d}/{mode}/{side}"
    os.makedirs(out, exist_ok=True)
    if side == "jax":
        from margin_tpu.params import Params
        from margin_tpu.polish.driver import run_polish
        kwargs = {k: v.format(vcf=vcf) if isinstance(v, str) else v
                  for k, v in kwargs.items()}
        run_polish(f"{d}/reads.bam", f"{d}/draft.fa",
                   Params.load(f"{d}/{params}"), f"{out}/out", diploid=True,
                   use_lut=True, log=lambda *a: None, **kwargs)
    else:
        from margin_tpu_torch import cli
        assert cli.main(
            ["polish", f"{d}/reads.bam", f"{d}/draft.fa", f"{d}/{params}",
             "-o", f"{out}/out", "--diploid", "-a", "CRITICAL", "--device",
             "cpu"] + [f.format(vcf=vcf) for f in flags]) == 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("diploid"))
    ds = write_diploid_polish_dataset(d, CONFIG)
    with open(ds.params) as fh:
        p = json.load(fh)
    p["polish"]["useRunLengthEncoding"] = False
    with open(f"{d}/params_norle.json", "w") as fh:
        json.dump(p, fh)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               MARGIN_TPU_NATIVE_SCAN_CELLS="1", OMP_NUM_THREADS="1")
    procs = []
    for mode in ["chunk0"] + list(MODES):
        for side in ("jax", "torch"):
            code = ("import sys; sys.path.insert(0, %r); "
                    "sys.path.insert(0, %r)\n"
                    "import test_torch_diploid as T\n"
                    "T.run_side(%r, %r, %r)\n" % (HERE, ROOT, side, d, mode))
            procs.append((mode, side, subprocess.Popen(
                [sys.executable, "-c", code], env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)))
    for mode, side, p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, (mode, side, err.decode()[-3000:])
    return d, ds


_NUMBER = re.compile(rb"-?\d+\.\d+")


def _same_poa_print(a, b, tol):
    """POA CSV / DOT text: identical but for decimals within tol."""
    if _NUMBER.sub(b"#", a) != _NUMBER.sub(b"#", b):
        return False
    return all(abs(float(x) - float(y)) <= tol
               for x, y in zip(_NUMBER.findall(a), _NUMBER.findall(b)))


@pytest.mark.parametrize("mode", list(MODES))
def test_outputs_identical(runs, mode):
    d, ds = runs
    tol = 1e-6 + 1e-7 * len(ds.read_hap)
    files = {side: sorted(os.listdir(f"{d}/{mode}/{side}"))
             for side in ("jax", "torch")}
    assert files["torch"] == files["jax"]
    flags = MODES[mode][0]
    want = {"out.chunks.csv"}
    if "-M" not in flags:
        want.add("out.haplotagged.bam")
    if "-T" not in flags:
        want |= {"out.hap1.fa", "out.hap2.fa"}
    assert want <= set(files["torch"])
    if mode == "outputs":
        kinds = {f.split(".")[1] for f in files["torch"]}
        assert {"poa", "repeatCount", "readIds"} <= kinds
        assert sum(f.endswith(".phasingInfo.json")
                   for f in files["torch"]) == 2
    for f in files["torch"]:
        with open(f"{d}/{mode}/torch/{f}", "rb") as fa, \
                open(f"{d}/{mode}/jax/{f}", "rb") as fb:
            a, b = fa.read(), fb.read()
        if f.startswith("out.poa."):
            assert _same_poa_print(a, b, tol), f
        else:
            assert a == b, f


def test_every_chunk_phases_several_bubbles(runs):
    d, _ = runs
    infos = sorted(f for f in os.listdir(f"{d}/outputs/torch")
                   if f.endswith(".phasingInfo.json"))
    for f in infos:
        with open(f"{d}/outputs/torch/{f}") as fh:
            assert len(json.load(fh)["primary"]) >= 2, f


def test_haplotags_follow_the_true_haplotypes(runs):
    """Up to a swap, the tagged reads' HP tags are their true haplotypes."""
    from margin_tpu_torch.io import bam as bamio
    d, ds = runs
    agree = tagged = 0
    with bamio.BamReader(f"{d}/plain/torch/out.haplotagged.bam") as r:
        for rec in r:
            blob = rec.tags_blob()
            i = blob.find(b"HPi")
            if i < 0:
                continue
            tagged += 1
            agree += struct.unpack_from("<i", blob, i + 3)[0] \
                == ds.read_hap[rec.name]
    assert tagged >= len(ds.read_hap) // 2
    assert max(agree, tagged - agree) >= 0.9 * tagged


def _chunk0_of(d):
    out = {}
    for side in ("jax", "torch"):
        with open(f"{d}/chunk0.{side}.pkl", "rb") as fh:
            out[side] = pickle.load(fh)
    return out


def test_chunk0_hap_read_sets_identical(runs):
    got = _chunk0_of(runs[0])
    hap1, hap2, _ = got["torch"]
    assert hap1 and hap2
    assert (hap1, hap2) == got["jax"][:2]


def test_chunk0_phased_repeat_counts_identical(runs):
    got = _chunk0_of(runs[0])
    counts = got["torch"][2]
    assert all(len(c) > 1000 for c in counts)
    assert counts == got["jax"][2]


@pytest.mark.cuda
def test_diploid_kernels_match_plain(tmp_path):
    """Diploid polish of the CONFIG set through the kernels, then through
    their plain twins bound in the wrappers' place, with SEG_MIN_D lowered
    to 1024 so K3 runs beside K2 (the reads span 700-1400 diagonals):
    identical hap FASTAs and haplotagged BAM records."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from margin_tpu_torch.io import bam as bamio
    from margin_tpu_torch.ops import banded, cuda_banded, pairhmm
    from margin_tpu_torch.params import Params
    from margin_tpu_torch.polish.driver import run_polish
    ds = write_diploid_polish_dataset(str(tmp_path), CONFIG)
    params = Params.load(ds.params)
    twins = {(pairhmm, "forward_total"): pairhmm.forward_total_plain,
             (cuda_banded, "fb_forward"): cuda_banded.fb_forward_plain,
             (cuda_banded, "fb_backward"): cuda_banded.fb_backward_plain,
             (cuda_banded, "seg_forward"): cuda_banded.seg_forward_plain,
             (cuda_banded, "seg_backward"):
                 lambda pack, ckpt, totals, use_lut, seg_d, threshold,
                 cap=None: cuda_banded.seg_backward_plain(
                     pack, ckpt, totals, use_lut, seg_d, threshold)}
    saved = {k: getattr(*k) for k in twins}
    saved_min = banded.SEG_MIN_D
    banded.SEG_MIN_D = 1024
    try:
        k1 = pairhmm.FORWARD_TOTAL.launches
        k3 = cuda_banded.SEG_FORWARD.launches
        run_polish(ds.bam, ds.draft, params, f"{tmp_path}/kern",
                   diploid=True, use_lut=True, device="cuda",
                   log=lambda *a: None)
        assert pairhmm.FORWARD_TOTAL.launches > k1
        assert cuda_banded.SEG_FORWARD.launches > k3
        for (mod, name), fn in twins.items():
            setattr(mod, name, fn)
        run_polish(ds.bam, ds.draft, params, f"{tmp_path}/plain",
                   diploid=True, use_lut=True, device="cuda",
                   log=lambda *a: None)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
        banded.SEG_MIN_D = saved_min
    for ext in ("hap1.fa", "hap2.fa"):
        with open(f"{tmp_path}/kern.{ext}", "rb") as a, \
                open(f"{tmp_path}/plain.{ext}", "rb") as b:
            assert a.read() == b.read(), ext

    def records(path):
        with bamio.BamReader(path) as r:
            return [(rec.name, rec.flag, rec.pos, rec.tags_blob())
                    for rec in r]
    assert records(f"{tmp_path}/kern.haplotagged.bam") == \
        records(f"{tmp_path}/plain.haplotagged.bam")
