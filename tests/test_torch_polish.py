"""The port's haploid `margin polish` slice end to end against the JAX
package.

One seeded synthetic set (margin_tpu_torch.testing.synth
.write_polish_dataset): a 4.5 kb draft contig with substitutions and
1-3 bp indels (many in homopolymers), 10x of 0.8-2 kb reads on both
strands with the chip run's ~8% error model (3% substitutions, 2%
insertions, 3% deletions), chunks of 1800 bp with 180 bp boundaries, so
there are two stitch seams, one POA-consensus iteration and one bubble
pass (allele scoring on the dense forward, K1). margin_tpu's run_polish (in a
subprocess, on its CPU path with the banded problems on its exact native
engine, MARGIN_TPU_NATIVE_SCAN_CELLS=1, and XLA's FMA contraction off,
see tests/test_torch_pairhmm.py) and `python -m margin_tpu_torch polish
--device cpu` (cli.main, in process) must write byte-identical FASTA. The
port side lowers banded.SEG_MIN_D to 2048 and the segment depth to 256,
so the segmented kernels' plain twins (K3) run on the deeper reads beside
the monolithic ones (K2). The bubble consensus (dense forward, K1) is
held to the JAX package's on the first chunk's POA.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from margin_tpu_torch.ops import banded, cuda_banded
from margin_tpu_torch.testing.synth import (PolishSynthConfig,
                                            banded_edit_distance,
                                            write_polish_dataset)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = PolishSynthConfig(contig_len=4500, coverage=10.0,
                           read_len=(800, 2000), p_sub=0.03, p_ins=0.02,
                           p_del=0.03, chunk_size=1800, chunk_boundary=180,
                           poa_consensus_iterations=1,
                           realign_polish_iterations=1, seed=3)


def _overlap_pair(seed=5):
    """A prefix and a suffix that overlap by ~600 bases, with a few edits
    between the two copies of the overlap."""
    rng = np.random.default_rng(seed)
    s = "".join("ACGT"[i] for i in rng.integers(0, 4, 2000))
    prefix = s[:1300]
    ov = list(s[700:1300])
    for i in rng.choice(len(ov), 6, replace=False):
        ov[i] = "ACGT"[(("ACGT".index(ov[i])) + 1) % 4]
    return prefix, "".join(ov) + s[1300:]


def _chunk0_inputs(d, params, rle_cls, fasta_cls, chunker, reads_mod, bamio):
    """(reads, alignments, rle reference) of the first chunk."""
    pp = params.polish
    ch = chunker.construct_chunker(f"{d}/reads.bam", None, None, pp,
                                   record_filtered_reads=False).chunks[0]
    raw = fasta_cls(f"{d}/draft.fa").fetch(
        ch.ref_name, ch.chunk_overlap_start, ch.chunk_overlap_end).upper()
    ref = rle_cls.encode(raw)
    reader = bamio.open_alignment(f"{d}/reads.bam")
    reads, alns, _, _ = reads_mod.convert_to_reads_and_alignments(
        ch, ref, reader, pp, keep_filtered=False)
    reader.close()
    return reads, alns, ref


def _poa_summary(poa, pp):
    cons, p2c = poa.get_consensus(pp)
    return {"bw": poa._bw.copy(), "rw": poa._rw.copy(),
            "ins": [[(pi.insert.bases, list(pi.insert.counts),
                      pi.weight_fwd, pi.weight_rev) for pi in n.inserts]
                    for n in poa.nodes],
            "dels": [[(pd.length, pd.weight_fwd, pd.weight_rev)
                      for pd in n.deletes] for n in poa.nodes],
            "consensus": (cons.bases, list(cons.counts)),
            "poa_to_consensus": list(p2c)}


def _bubble_summary(poa, reads, params, tables, bubbles_poa):
    bg = bubbles_poa.bubble_graph_from_poa(poa, reads, None, params, tables,
                                           use_lut=True)
    path = bubbles_poa.get_consensus_path(bg)
    cons, p2c = bubbles_poa.get_consensus_string(bg, path, params.polish)
    return {"supports": [b.allele_read_supports for b in bg.bubbles],
            "alleles": [[a.bases for a in b.alleles] for b in bg.bubbles],
            "path": list(path), "consensus": (cons.bases, list(cons.counts)),
            "poa_to_consensus": list(p2c)}


def run_jax_side(d):
    """Subprocess body: margin_tpu's run_polish, its poa_realign and bubble
    consensus on the first chunk and its remove_overlap, pickled to
    d/jax.pkl."""
    from margin_tpu.io import bam as bamio
    from margin_tpu.io.fasta import FastaIndex
    from margin_tpu.ops import pairhmm
    from margin_tpu.params import Params
    from margin_tpu.phase import chunker
    from margin_tpu.polish import bubbles_poa
    from margin_tpu.polish import reads as reads_mod
    from margin_tpu.polish.driver import run_polish
    from margin_tpu.polish.poa import poa_realign
    from margin_tpu.polish.stitcher import remove_overlap
    from margin_tpu.rle import RleString
    params = Params.load(f"{d}/params.json")
    run_polish(f"{d}/reads.bam", f"{d}/draft.fa", params, f"{d}/jax",
               use_lut=True, log=lambda *a: None)
    pp = params.polish
    tables = pairhmm.PairHmmTables.from_params(pp.sm_forward, pp.sm_reverse)
    reads, alns, ref = _chunk0_inputs(d, params, RleString, FastaIndex,
                                      chunker, reads_mod, bamio)
    poa = poa_realign(reads, alns, ref, pp, tables, use_lut=True)
    prefix, suffix = _overlap_pair()
    with open(f"{d}/jax.pkl", "wb") as fh:
        pickle.dump({"poa": _poa_summary(poa, pp),
                     "bubbles": _bubble_summary(poa, reads, params, tables,
                                                bubbles_poa),
                     "overlap": remove_overlap(prefix, suffix, 800, params)},
                    fh)


@pytest.fixture(scope="module")
def polished(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("polish"))
    ds = write_polish_dataset(d, CONFIG)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               MARGIN_TPU_NATIVE_SCAN_CELLS="1")
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import jax; jax.config.update('jax_platforms', 'cpu')\n"
            "import test_torch_polish as T\n"
            "T.run_jax_side(%r)\n" % (HERE, os.path.dirname(HERE), d))
    jax_proc = subprocess.Popen([sys.executable, "-c", code], env=env)
    saved = (banded.SEG_MIN_D, dict(cuda_banded.SEG_D))
    try:
        from margin_tpu_torch import cli
        banded.SEG_MIN_D = 2048
        cuda_banded.SEG_D.update({w: 256 for w in cuda_banded.SEG_D})
        banded.ROUTES.reset()
        launches = cuda_banded.SEG_FORWARD.launches
        assert cli.main(["polish", ds.bam, ds.draft, ds.params, "-o",
                         f"{d}/torch", "--device", "cpu", "--profile",
                         "-a", "CRITICAL"]) == 0
        routes = (banded.ROUTES.seg_items, banded.ROUTES.pack_items)
        # the CPU runs the twins: no kernel launched
        assert cuda_banded.SEG_FORWARD.launches == launches
    finally:
        banded.SEG_MIN_D = saved[0]
        cuda_banded.SEG_D.clear()
        cuda_banded.SEG_D.update(saved[1])
        assert jax_proc.wait(timeout=600) == 0
    with open(f"{d}/jax.pkl", "rb") as fh:
        jax_out = pickle.load(fh)
    return d, ds, routes, jax_out


def _seq(path):
    with open(path) as fh:
        return "".join(line.strip() for line in fh if line[0] != ">")


def test_polished_fasta_byte_identical(polished):
    d, _, _, _ = polished
    with open(f"{d}/torch.fa", "rb") as a, open(f"{d}/jax.fa", "rb") as b:
        assert a.read() == b.read()
    assert os.path.exists(f"{d}/torch.profile.json")


def test_polish_moves_the_draft_towards_the_truth(polished):
    d, ds, _, _ = polished
    truth, draft, out = _seq(ds.truth), _seq(ds.draft), _seq(f"{d}/torch.fa")
    assert banded_edit_distance(out, truth, 300) < \
        banded_edit_distance(draft, truth, 300)


def test_segmented_and_monolithic_routes_both_ran(polished):
    _, _, (seg_items, pack_items), _ = polished
    assert seg_items > 0 and pack_items > 0


@pytest.fixture(scope="module")
def chunk0(polished):
    """The port's poa_realign of the first chunk, and its inputs."""
    from margin_tpu_torch.io import bam as bamio
    from margin_tpu_torch.io.fasta import FastaIndex
    from margin_tpu_torch.ops import pairhmm
    from margin_tpu_torch.params import Params
    from margin_tpu_torch.phase import chunker
    from margin_tpu_torch.polish import reads as reads_mod
    from margin_tpu_torch.polish.poa import poa_realign
    from margin_tpu_torch.rle import RleString
    d, ds, _, _ = polished
    params = Params.load(ds.params)
    pp = params.polish
    tables = pairhmm.PairHmmTables.from_params(pp.sm_forward, pp.sm_reverse,
                                               device="cpu")
    reads, alns, ref = _chunk0_inputs(d, params, RleString, FastaIndex,
                                      chunker, reads_mod, bamio)
    poa = poa_realign(reads, alns, ref, pp, tables, use_lut=True)
    return poa, reads, params, tables


def test_poa_realign_matches(polished, chunk0):
    """poa_realign on the first chunk: the same inserts and deletes, node
    weights within one unit (1e-7 in probability) per read, and an
    identical POA consensus. The scaled posteriors floor(p * 1e7) of a few
    cells differ by one unit: exp() is the C library's in the JAX
    package's native engine and PyTorch's in the port's twins, a last-bit
    float32 difference (ROADMAP queue 3)."""
    poa, reads, params, _ = chunk0
    mine = _poa_summary(poa, params.polish)
    theirs = polished[3]["poa"]
    tol = len(reads)
    for key in ("bw", "rw"):
        assert mine[key].shape == theirs[key].shape
        assert np.abs(mine[key] - theirs[key]).max() <= tol, key
    for key in ("ins", "dels"):
        for a, b in zip(mine[key], theirs[key]):
            assert [e[:-2] for e in a] == [e[:-2] for e in b], key
            assert np.abs(np.array([e[-2:] for e in a] or [[0, 0]])
                          - np.array([e[-2:] for e in b] or [[0, 0]])
                          ).max() <= tol, key
    for key in ("consensus", "poa_to_consensus"):
        assert mine[key] == theirs[key], key


def test_bubble_consensus_matches(polished, chunk0):
    """The bubble graph of the first chunk's POA, its allele supports from
    the dense forward (K1's twin against XLA's scan), the consensus path
    and string."""
    from margin_tpu_torch.polish import bubbles_poa
    poa, reads, params, tables = chunk0
    mine = _bubble_summary(poa, reads, params, tables, bubbles_poa)
    theirs = polished[3]["bubbles"]
    assert len(mine["supports"]) == len(theirs["supports"]) > 0
    for a, b in zip(mine["supports"], theirs["supports"]):
        assert np.array_equal(a, b)
    for key in ("alleles", "path", "consensus", "poa_to_consensus"):
        assert mine[key] == theirs[key], key


def test_remove_overlap_matches(polished):
    from margin_tpu_torch.params import Params
    from margin_tpu_torch.polish.stitcher import remove_overlap
    _, ds, _, jax_out = polished
    prefix, suffix = _overlap_pair()
    got = remove_overlap(prefix, suffix, 800, Params.load(ds.params),
                         device="cpu")
    assert got == jax_out["overlap"]
    assert got[0] > 0 and 0 < got[1] <= len(prefix)
