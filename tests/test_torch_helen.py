"""The port's HELEN feature output (`margin polish -f/-F/-u`,
margin_tpu_torch.polish.helen) against the JAX package's.

One seeded synthetic set (margin_tpu_torch.testing.synth
.write_polish_dataset): a 1.4 kb draft with draft errors, 6x of 0.5-1.2 kb
reads with a low error model (1% substitutions, 0.5% insertions, 1%
deletions) so one POA-consensus iteration brings the consensus within the
99% identity the truth labels need, one chunk, and truth.bam (the truth
aligned to the draft). The three feature types, with labels (-u) and
without, run through margin_tpu's run_polish(use_lut=True) (in
subprocesses, its CPU path with the banded problems on its exact native
engine, MARGIN_TPU_NATIVE_SCAN_CELLS=1, XLA's FMA contraction off) and
through `margin_tpu_torch.cli.main --device cpu` in process; simpleWeight
on the set's params with run-length encoding off.

The HDF5 files must hold the same groups and datasets with the same
dtypes and shapes, and equal labels, positions and window headers. Image
values may differ by one: the POA's node weights differ by up to one unit
of 1e-7 per read between the packages (exp() is the C library's in the
JAX package's native banded engine and PyTorch's in the port's twins, a
last-bit float32 difference, ROADMAP queue 3), and a weight normalised to
254 levels can round across a level. Features computed from one POA
handed to both packages' functions must be equal exactly.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from margin_tpu_torch.testing.synth import (PolishSynthConfig,
                                            write_polish_dataset)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CONFIG = PolishSynthConfig(contig_len=1400, coverage=6.0,
                           read_len=(500, 1200), p_sub=0.01, p_ins=0.005,
                           p_del=0.01, chunk_size=1400, chunk_boundary=100,
                           poa_consensus_iterations=1,
                           realign_polish_iterations=0, seed=3)
# mode -> (feature type, with labels, params file)
MODES = {f"{ft}{'_labels' if lab else ''}": (ft, lab, params)
         for ft, params in (("splitRleWeight", "params.json"),
                            ("channelRleWeight", "params.json"),
                            ("simpleWeight", "params_norle.json"))
         for lab in (True, False)}


def run_jax_side(d, modes):
    """Subprocess body: margin_tpu's run_polish for each mode into
    d/<mode>.jax.T00.h5."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from margin_tpu.params import Params
    from margin_tpu.polish.driver import run_polish
    for mode in modes:
        ft, lab, params = MODES[mode]
        run_polish(f"{d}/reads.bam", f"{d}/draft.fa",
                   Params.load(f"{d}/{params}"), f"{d}/{mode}.jax",
                   feature_type=ft,
                   true_reference_bam=f"{d}/truth.bam" if lab else None,
                   use_lut=True, log=lambda *a: None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("helen"))
    ds = write_polish_dataset(d, CONFIG)
    with open(ds.params) as fh:
        p = json.load(fh)
    p["polish"]["useRunLengthEncoding"] = False
    with open(f"{d}/params_norle.json", "w") as fh:
        json.dump(p, fh)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               MARGIN_TPU_NATIVE_SCAN_CELLS="1", OMP_NUM_THREADS="1")
    modes = list(MODES)
    procs = []
    for part in (modes[:3], modes[3:]):
        code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
                "import test_torch_helen as T\n"
                "T.run_jax_side(%r, %r)\n" % (HERE, ROOT, d, part))
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE))
    from margin_tpu_torch import cli
    try:
        for mode, (ft, lab, params) in MODES.items():
            argv = ["polish", ds.bam, ds.draft, f"{d}/{params}", "-o",
                    f"{d}/{mode}.torch", "-F", ft, "--device", "cpu", "-a",
                    "CRITICAL"]
            assert cli.main(argv + (["-u", ds.truth_bam] if lab else [])) \
                == 0
    finally:
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err.decode()[-3000:]
    return d, ds


def _read_h5(path):
    import h5py
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[()]
        f.visititems(visit)
    return out


IMAGES = ("image", "nucleotide", "runLength", "normalization")


@pytest.mark.parametrize("mode", list(MODES))
def test_hdf5_matches_jax(runs, mode):
    d, _ = runs
    mine = _read_h5(f"{d}/{mode}.torch.T00.h5")
    theirs = _read_h5(f"{d}/{mode}.jax.T00.h5")
    assert sorted(mine) == sorted(theirs)
    assert len(mine) > 0
    _, lab, _ = MODES[mode]
    assert any(k.endswith("label_base") for k in mine) == lab
    n_diff = 0
    for name, a in mine.items():
        b = theirs[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name.rsplit("/", 1)[-1] in IMAGES:
            diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
            assert diff.max(initial=0) <= 1, name
            n_diff += int((diff > 0).sum())
        else:
            assert np.array_equal(a, b), name
    print(f"{mode}: {n_diff} image values differ by one")


def test_labels_follow_the_truth(runs):
    """With -u the labelled windows cover the chunk: most label bases are
    nucleotides (1-4), the rest gaps (0: insert columns, run-length
    continuation rows and true deletions)."""
    d, _ = runs
    got = _read_h5(f"{d}/splitRleWeight_labels.torch.T00.h5")
    labels = np.concatenate([a.ravel() for k, a in got.items()
                             if k.endswith("label_base")])
    assert len(labels) >= 1000
    assert (labels > 0).mean() > 0.75 and labels.max() <= 4


@pytest.fixture(scope="module")
def one_poa(runs):
    """The port's POA of the set's chunk (RLE params, realigned to its
    consensus as the driver does), its reads, the chunk and the truth
    alignment."""
    from margin_tpu_torch.io import bam as bamio
    from margin_tpu_torch.io.fasta import FastaIndex
    from margin_tpu_torch.ops import pairhmm
    from margin_tpu_torch.params import Params
    from margin_tpu_torch.phase import chunker
    from margin_tpu_torch.polish import helen
    from margin_tpu_torch.polish.driver import poa_realign_all
    from margin_tpu_torch.polish.reads import convert_to_reads_and_alignments
    from margin_tpu_torch.rle import RleString
    d, ds = runs
    params = Params.load(ds.params)
    pp = params.polish
    chunk = chunker.construct_chunker(ds.bam, None, None, pp,
                                      record_filtered_reads=False).chunks[0]
    ref = RleString.encode(FastaIndex(ds.draft).fetch(
        chunk.ref_name, chunk.chunk_overlap_start,
        chunk.chunk_overlap_end).upper())
    reader = bamio.open_alignment(ds.bam)
    reads, alns, _, _ = convert_to_reads_and_alignments(chunk, ref, reader,
                                                        pp)
    reader.close()
    tables = pairhmm.PairHmmTables.from_params(pp.sm_forward, pp.sm_reverse,
                                               device="cpu")
    poa = poa_realign_all(reads, alns, ref, params, tables, use_lut=True)
    pairs, truth = helen.get_truth_alignment(chunk, ds.truth_bam, ref,
                                             poa.ref_string, params, tables,
                                             use_lut=True)
    assert pairs is not None
    return poa, reads, chunk, pairs, truth


_KINDS = {"simple": ("get_simple_weight_features",
                     "write_simple_weight_features_h5", ()),
          "split": ("get_split_rle_weight_features",
                    "write_split_rle_weight_features_h5", (10,)),
          "channel": ("get_channel_rle_weight_features",
                      "write_channel_rle_weight_features_h5", (10,))}


@pytest.mark.parametrize("kind", list(_KINDS))
def test_features_of_one_poa_equal(one_poa, kind):
    """Both packages' feature functions on the port's POA: equal feature
    weights, equal truth labels and equal arrays for the HDF5 file."""
    from margin_tpu.polish import helen as jhelen
    from margin_tpu_torch.polish import helen
    poa, reads, chunk, pairs, truth = one_poa
    get, write, extra = _KINDS[kind]
    arrays = []
    for mod in (helen, jhelen):
        feats = getattr(mod, get)(poa, reads, *extra)
        first, last = mod.annotate_features_with_truth(feats, kind, pairs,
                                                       truth)
        sink = helen.HelenArrays()
        getattr(mod, write)(sink, "base", chunk, True, feats, first, last,
                            *extra)
        arrays.append(sink.groups)
    mine, theirs = arrays
    assert len(mine) > 0 and mine.keys() == theirs.keys()
    for g in mine:
        assert mine[g].keys() == theirs[g].keys()
        for k, a in mine[g].items():
            assert a.dtype == theirs[g][k].dtype
            assert np.array_equal(a, theirs[g][k]), (g, k)


def test_missing_h5py_names_the_package(monkeypatch, tmp_path):
    """Without h5py, -f stops at once with an ImportError naming it."""
    import builtins
    from margin_tpu_torch.polish import helen
    real = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        helen.HelenHDF5File(str(tmp_path / "x.h5"))
