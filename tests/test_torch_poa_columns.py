"""The native POA graph kept as columns (`polish/native_poa.py:PoaColumns`)
against the node objects it builds on first access and the Python `Poa`.

One chunk of the seeded polish set of `tests/test_torch_polish.py` is
realigned once (`poa_realign`, the banded twins on the CPU) with every
augmentation recorded; each test replays the record into a fresh native
builder (a graph with columns) or a fresh Python `Poa` (nodes only). The
columns' readers (iteration score, consensus, repeat counts' flat
observations) must give exactly what the per-object paths give, the lazily
built nodes must equal the Python builder's, and a haploid polish builds
the nodes once per chunk (`tests/test_torch_profiling.py`, on its run).
"""

import copy
import importlib.util
import os

import numpy as np
import pytest
import torch

from margin_tpu_torch.polish import native_poa, poa as poa_mod, repeats
from margin_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """(reference, max_rc, params, augment calls, reads) of chunk 0's
    poa_realign."""
    from test_torch_polish import CONFIG, _chunk0_inputs
    from margin_tpu_torch.io import bam as bamio
    from margin_tpu_torch.io.fasta import FastaIndex
    from margin_tpu_torch.ops import pairhmm
    from margin_tpu_torch.params import Params
    from margin_tpu_torch.phase import chunker
    from margin_tpu_torch.polish import reads as reads_mod
    from margin_tpu_torch.rle import RleString
    from margin_tpu_torch.testing.synth import write_polish_dataset
    if native_poa.lib() is None:
        pytest.fail("the native POA engine did not build")
    d = str(tmp_path_factory.mktemp("poa_columns"))
    ds = write_polish_dataset(d, CONFIG)
    params = Params.load(ds.params)
    pp = params.polish
    tables = pairhmm.PairHmmTables.from_params(pp.sm_forward, pp.sm_reverse,
                                               device="cpu")
    reads, alns, ref = _chunk0_inputs(d, params, RleString, FastaIndex,
                                      chunker, reads_mod, bamio)
    calls, made = [], []

    class Recorder(native_poa.NativePoaBuilder):
        def __init__(self, reference, max_rc, params):
            super().__init__(reference, max_rc, params)
            made.append((reference, max_rc))

        def augment(self, *args):
            calls.append(args)
            super().augment(*args)

    saved = poa_mod._make_poa_builder
    poa_mod._make_poa_builder = Recorder
    try:
        graph = poa_mod.poa_realign(reads, alns, ref, pp, tables,
                                    use_lut=True)
    finally:
        poa_mod._make_poa_builder = saved
    reference, max_rc = made[0]
    assert graph._cols is not None and graph.built_nodes() is None
    return reference, max_rc, pp, calls, reads


def _native(rec):
    reference, max_rc, pp, calls, _ = rec
    b = native_poa.NativePoaBuilder(reference, max_rc, pp)
    for args in calls:
        b.augment(*args)
    return b.finish()


def _python(rec):
    reference, max_rc, pp, calls, _ = rec
    p = poa_mod.Poa(reference, max_rc)
    for args in calls:
        p.augment(*args)
    return p


def _node_fields(nodes):
    return [(n.base, n.repeat_count, n.base_weights.tolist(),
             n.repeat_count_weights.tolist(), n.observations,
             [(pi.insert.bases, pi.insert.counts.tolist(), pi.weight_fwd,
               pi.weight_rev, pi.observations) for pi in n.inserts],
             [(pd.length, pd.weight_fwd, pd.weight_rev, pd.observations)
              for pd in n.deletes]) for n in nodes]


def test_the_built_nodes_equal_the_python_builders(recorded):
    g = _native(recorded)
    prof = profiling.Profiler(enabled=True)
    with prof.stage("build"):
        nodes = g.nodes
        assert g.nodes is nodes                  # built once
    spans = prof.summary()["spans"]["poa.materialise"]
    assert spans["n"] == 1 and spans["work"] == len(nodes)
    py = _python(recorded)
    assert sum(len(n.inserts) for n in nodes) > 0
    assert sum(len(n.deletes) for n in nodes) > 0
    assert _node_fields(nodes) == _node_fields(py.nodes)


@pytest.mark.parametrize("state", ["columns", "built", "repeat_counts"])
def test_the_score_from_columns_is_the_per_object_sum(recorded, state):
    """The iteration score's two sums, bit for bit (`==`), on a graph whose
    nodes were not built, were built, and after repeat counts."""
    g = _native(recorded)
    if state == "repeat_counts":
        reads, pp = recorded[4], recorded[2]
        repeats.estimate_repeat_counts(g, reads, pp.repeat_sub_matrix)
    match, error = g.total_match_weight(), g.total_error_weight()
    if state != "columns":
        g.nodes
    assert match == g._total_match_weight_py()
    assert error == g._total_error_weight_py()
    py = _python(recorded)
    assert match == py.total_match_weight()
    assert error == py.total_error_weight()


@pytest.mark.parametrize("sorted_obs", [False, True])
def test_flat_observations_from_columns_equal_the_tuples(recorded,
                                                         sorted_obs):
    """_FlatObs of the columns, also in the order sort_observations gives
    the tuples, array for array against the tuple walk."""
    reads, pp = recorded[4], recorded[2]
    g = _native(recorded)
    if sorted_obs:
        g.sort_observations()
        assert g._cols.obs_order is not None
    mr = pp.repeat_sub_matrix.max_repeat
    cols = repeats._FlatObs.of_poa(g, reads, mr)
    tuples = repeats._FlatObs.of_nodes(g.nodes[1:], reads, mr)
    for key in ("starts", "counts", "weights", "strands", "read_nos"):
        a, b = getattr(cols, key), getattr(tuples, key)
        assert a.dtype == b.dtype and np.array_equal(a, b), key


def test_consensus_from_columns_equals_the_objects(recorded):
    reads, pp = recorded[4], recorded[2]
    g = _native(recorded)
    repeats.estimate_repeat_counts(g, reads, pp.repeat_sub_matrix)
    cons, p2c = native_poa.consensus(g, pp)
    objects = copy.copy(g)
    objects._cols = None                        # the node-walking path
    objects.nodes = g.nodes
    cons_o, p2c_o = native_poa.consensus(objects, pp)
    cons_py, p2c_py = g._get_consensus_py(pp)
    assert cons.bases == cons_o.bases == cons_py.bases
    assert cons.counts.tolist() == cons_o.counts.tolist() \
        == cons_py.counts.tolist()
    assert np.array_equal(p2c, p2c_o) and np.array_equal(p2c, p2c_py)


def test_repeat_counts_reach_nodes_built_later(recorded):
    """estimate_repeat_counts on the columns builds no nodes; nodes built
    afterwards carry its counts, which equal the tuple path's."""
    reads, pp = recorded[4], recorded[2]
    g = _native(recorded)
    before = g.ref_string.counts.copy()
    repeats.estimate_repeat_counts(g, reads, pp.repeat_sub_matrix)
    assert g.built_nodes() is None
    assert not np.array_equal(g.ref_string.counts, before)
    assert [n.repeat_count for n in g.nodes] == \
        [1] + g.ref_string.counts.tolist()
    py = _python(recorded)
    repeats.estimate_repeat_counts(py, reads, pp.repeat_sub_matrix)
    assert [n.repeat_count for n in py.nodes] == \
        [n.repeat_count for n in g.nodes]
    assert py.ref_string.non_rle_length == g.ref_string.non_rle_length
    # and on built nodes the counts are written through
    g2 = _native(recorded)
    g2.nodes
    repeats.estimate_repeat_counts(g2, reads, pp.repeat_sub_matrix)
    assert [n.repeat_count for n in g2.nodes] == \
        [n.repeat_count for n in g.nodes]


@pytest.mark.parametrize("n_spans", [0, 1])
def test_the_materialise_reader_gives_seconds_a_mb(n_spans):
    path = os.path.join(ROOT, "portbench", "metrics",
                        "polish.poa_materialise_s_per_mb.py")
    spec = importlib.util.spec_from_file_location("poa_materialise", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Run:
        kb = 400.0
        profile = {"spans": {"other": {"n": 1, "total_s": 9.0}}}

    if n_spans:
        Run.profile["spans"]["poa.materialise"] = {"n": 4, "total_s": 3.0}
        assert mod.read(Run) == pytest.approx(7.5)
    else:
        assert mod.read(Run) is None              # the parent: no span
