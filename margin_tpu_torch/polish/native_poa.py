"""ctypes binding for the native POA augmentation engine
(native/marginpoa.cc).

Counterpart of `margin_tpu/polish/native_poa.py`: poa_augment's run
grouping, left-shift normalization and observation bookkeeping
(poa.c:269-543) and poa_getConsensus run in C++, bit-identical to the
Python `Poa`; after all reads are augmented the serialized graph is
wrapped, column by column, in a `Poa` (PoaColumns), whose node objects
are built only for the readers that walk them. The library is built from
native/marginpoa.cc by `margin_tpu_torch._ext` into the port's build
directory (never native/libmarginpoa.so). When it does not build, the
Python `Poa` runs instead (host code either way).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOAD_LOCK = threading.Lock()

_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def lib() -> Optional[ctypes.CDLL]:
    """The engine, loaded once under a lock (chunk threads ask at once)."""
    with _LOAD_LOCK:
        return _load()


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    from margin_tpu_torch import _ext
    L = _ext.native_lib("marginpoa")
    if L is None:
        return None
    L.mpoa_create.restype = ctypes.c_void_p
    L.mpoa_create.argtypes = [_U8P, _I64P, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int32, ctypes.c_int32]
    L.mpoa_free.argtypes = [ctypes.c_void_p]
    L.mpoa_free.restype = None
    L.mpoa_augment.restype = None
    L.mpoa_augment.argtypes = [
        ctypes.c_void_p, _U8P, _I64P, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        _I64P, ctypes.c_int64, _I64P, ctypes.c_int64,
        _I64P, ctypes.c_int64]
    L.mpoa_export.restype = ctypes.c_int64
    L.mpoa_export.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    L.mpoa_buf_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    L.mpoa_buf_free.restype = None
    _I8P = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
    _F64P = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    L.mpoa_consensus.restype = ctypes.c_int64
    L.mpoa_consensus.argtypes = [
        ctypes.c_int64, _F64P, _F64P, ctypes.c_int64,
        _I8P, _I64P,
        _I64P, _I64P, _U8P, _I64P, _F64P,
        _I64P, _I64P, _F64P,
        ctypes.c_double, ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    _LIB = L
    return _LIB


def consensus(poa, params):
    """Native poa_getConsensus (poa.c:1350-1588): bit-identical to
    Poa.get_consensus's Python forward+traceback, at C speed. Returns
    (consensus RleString, poaToConsensusMap) or None when the engine is
    unavailable. Weights/repeat-counts are snapshotted fresh from the Poa
    (repeat estimation mutates them between realign and consensus)."""
    L = lib()
    if L is None:
        return None
    from margin_tpu_torch.alphabet import seq_to_symbols
    from margin_tpu_torch.rle import RleString

    n_nodes = len(poa._bw)
    # node weight arrays are views into the shared accumulators; nodes[0]
    # is the 'N' prefix and nodes[1:] mirror ref_string (poa.py _make_node)
    bw = np.ascontiguousarray(poa._bw, dtype=np.float64)
    rw = np.ascontiguousarray(poa._rw, dtype=np.float64)
    max_rc = int(poa.max_repeat_count)
    node_syms = np.empty(n_nodes, dtype=np.int8)
    node_syms[0] = 4
    node_syms[1:] = seq_to_symbols(poa.ref_string.bases)
    if poa._cols is not None:
        indels = poa._cols.consensus_indels(poa.ref_string)
    else:
        indels = _consensus_indels(poa.nodes)
    (node_rcs, ins_node_counts, ins_off, ins_bases, ins_counts, ins_w,
     del_node_counts, del_len, del_w) = indels

    out = ctypes.POINTER(ctypes.c_uint8)()
    nbytes = L.mpoa_consensus(
        n_nodes, bw, rw, max_rc, node_syms, node_rcs,
        ins_node_counts, ins_off, ins_bases, ins_counts, ins_w,
        del_node_counts, del_len, del_w,
        float(params.referenceBasePenalty),
        1 if params.useRunLengthEncoding else 0,
        ctypes.byref(out))
    if nbytes < 0:
        return None
    try:
        raw = ctypes.string_at(out, nbytes)
    finally:
        L.mpoa_buf_free(out)
    buf = np.frombuffer(raw, dtype=np.uint8)
    cons_len = int(buf[:8].view(np.int64)[0])
    pad = (cons_len + 7) & ~7
    bases = buf[8:8 + cons_len].tobytes().decode("ascii")
    counts = buf[8 + pad:8 + pad + cons_len * 8].view(np.int64).copy()
    map_off = 8 + pad + cons_len * 8
    poa_to_consensus = buf[map_off:map_off + (n_nodes - 1) * 8] \
        .view(np.int64).copy()
    return RleString(bases, counts), poa_to_consensus


def _consensus_indels(nodes):
    """mpoa_consensus's repeat-count, insert and delete arguments walked
    from the node objects (a Python-built graph's only form)."""
    n_nodes = len(nodes)
    node_rcs = np.fromiter((n.repeat_count for n in nodes), dtype=np.int64,
                           count=n_nodes)
    ins_node_counts = np.fromiter((len(n.inserts) for n in nodes),
                                  dtype=np.int64, count=n_nodes)
    ins_w, ins_lens, bases_parts, counts_parts = [], [], [], []
    for n in nodes:
        for pi in n.inserts:
            ins_w.append(pi.weight_fwd + pi.weight_rev)
            ins_lens.append(pi.insert.length)
            bases_parts.append(pi.insert.bases)
            counts_parts.append(pi.insert.counts)
    ins_off = np.zeros(len(ins_w) + 1, dtype=np.int64)
    if ins_lens:
        np.cumsum(ins_lens, out=ins_off[1:])
    ins_bases = np.frombuffer("".join(bases_parts).encode("ascii"),
                              dtype=np.uint8)
    ins_counts = (np.concatenate(counts_parts).astype(np.int64)
                  if counts_parts else np.zeros(0, dtype=np.int64))
    ins_w = np.asarray(ins_w, dtype=np.float64)

    del_node_counts = np.fromiter((len(n.deletes) for n in nodes),
                                  dtype=np.int64, count=n_nodes)
    del_len, del_w = [], []
    for n in nodes:
        for pd in n.deletes:
            del_len.append(pd.length)
            del_w.append(pd.weight_fwd + pd.weight_rev)
    return (node_rcs, ins_node_counts, ins_off,
            np.ascontiguousarray(ins_bases), ins_counts, ins_w,
            del_node_counts, np.asarray(del_len, dtype=np.int64),
            np.asarray(del_w, dtype=np.float64))


class NativePoaBuilder:
    """Accumulates per-read augmentations in C++, exports a Python Poa."""

    def __init__(self, reference, max_repeat_count: int, params):
        self._L = lib()
        if self._L is None:
            raise RuntimeError("native poa unavailable")
        self.reference = reference
        self.max_rc = max_repeat_count
        ref_b = np.frombuffer(reference.bases.encode("ascii"), dtype=np.uint8)
        ref_c = np.ascontiguousarray(reference.counts, dtype=np.int64)
        self._h = self._L.mpoa_create(
            np.ascontiguousarray(ref_b), ref_c, reference.length,
            max_repeat_count,
            1 if params.poaConstructCompareRepeatCounts else 0,
            1 if params.useRunLengthEncoding else 0)

    def augment(self, read, read_strand: bool, read_no: int,
                matches, inserts, deletes, params=None):
        rb = np.frombuffer(read.bases.encode("ascii"), dtype=np.uint8)
        rc = np.ascontiguousarray(read.counts, dtype=np.int64)
        m = np.ascontiguousarray(np.asarray(matches, dtype=np.int64)
                                 .reshape(-1, 3))
        i = np.ascontiguousarray(np.asarray(inserts, dtype=np.int64)
                                 .reshape(-1, 3))
        d = np.ascontiguousarray(np.asarray(deletes, dtype=np.int64)
                                 .reshape(-1, 3))
        self._L.mpoa_augment(self._h, np.ascontiguousarray(rb), rc,
                             read.length, 1 if read_strand else 0, read_no,
                             m, len(m), i, len(i), d, len(d))

    def finish(self):
        """Export the graph into a Poa that holds it as PoaColumns (its
        nodes are built on first access); frees the handle."""
        from margin_tpu_torch.polish.poa import Poa

        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self._L.mpoa_export(self._h, ctypes.byref(out))
        if n < 0:
            raise RuntimeError("mpoa_export failed")
        try:
            raw = ctypes.string_at(out, n)
        finally:
            self._L.mpoa_buf_free(out)
            self._L.mpoa_free(self._h)
            self._h = None

        cols = PoaColumns(np.frombuffer(raw, dtype=np.uint8))
        poa = Poa.__new__(Poa)
        poa.ref_string = self.reference.copy()
        poa.max_repeat_count = cols.max_rc
        poa._bw = cols.bw.copy()
        poa._rw = cols.rw.copy()
        poa._cols = cols
        return poa


class PoaColumns:
    """mpoa_export's buffer as columns (read-only views of it): the node
    weights, then the node observations, the inserts and the deletes, each
    in CSR form (a count per owner, then flat arrays in owner order; an
    observation is a read number, an offset and a weight).

    The score, the consensus, the anchors and the repeat counts read these;
    `nodes` builds the PoaNode / PoaInsert / PoaDelete objects for the
    readers that walk them (bubbles, HELEN, the supplemental writers)."""

    def __init__(self, buf: np.ndarray):
        pos = 0

        def take(count, dtype=np.int64):
            nonlocal pos
            v = buf[pos:pos + count * 8].view(dtype)
            pos += count * 8
            return v

        def obs(total):
            return take(total), take(total), take(total, np.float64)

        (n_nodes, self.max_rc, n_obs, n_ins, ins_bases_pad, n_ins_counts,
         n_ins_obs, n_del, n_del_obs, _rsv) = take(10).tolist()
        self.bw = take(n_nodes * 5, np.float64).reshape(n_nodes, 5)
        self.rw = take(n_nodes * self.max_rc,
                       np.float64).reshape(n_nodes, self.max_rc)
        self.node_obs_counts = take(n_nodes)
        self.obs_rn, self.obs_off, self.obs_wt = obs(n_obs)
        self.node_ins_counts = take(n_nodes)
        self.ins_len = take(n_ins)
        self.ins_bases = buf[pos:pos + n_ins_counts]
        pos += ins_bases_pad
        self.ins_counts = take(n_ins_counts)
        self.ins_wf = take(n_ins, np.float64)
        self.ins_wr = take(n_ins, np.float64)
        self.ins_obs_counts = take(n_ins)
        self.ins_obs = obs(n_ins_obs)
        self.node_del_counts = take(n_nodes)
        self.del_len = take(n_del)
        self.del_wf = take(n_del, np.float64)
        self.del_wr = take(n_del, np.float64)
        self.del_obs_counts = take(n_del)
        self.del_obs = obs(n_del_obs)
        # the node observations' order after Poa.sort_observations (the
        # tuples' order); None while they are in export order
        self.obs_order = None

    @property
    def n_nodes(self) -> int:
        return len(self.node_obs_counts)

    def node_observations(self):
        """(count per node, read numbers, offsets, weights), node-major in
        the order the nodes' observation tuples have."""
        rn, off, wt = self.obs_rn, self.obs_off, self.obs_wt
        if self.obs_order is not None:
            o = self.obs_order
            rn, off, wt = rn[o], off[o], wt[o]
        return self.node_obs_counts, rn, off, wt

    def sort_observations(self):
        """The order sortBaseObservations gives the tuples: per node by
        read number, then by weight descending, ties kept (both sorts are
        stable)."""
        node = np.repeat(np.arange(self.n_nodes), self.node_obs_counts)
        self.obs_order = np.lexsort((-self.obs_wt, self.obs_rn, node))

    def consensus_indels(self, ref_string):
        """mpoa_consensus's repeat-count, insert and delete arguments, as
        native_poa._consensus_indels walks them from the nodes."""
        node_rcs = np.empty(self.n_nodes, dtype=np.int64)
        node_rcs[0] = 1
        node_rcs[1:] = ref_string.counts
        ins_off = np.zeros(len(self.ins_len) + 1, dtype=np.int64)
        np.cumsum(self.ins_len, out=ins_off[1:])
        return (node_rcs, self.node_ins_counts, ins_off, self.ins_bases,
                self.ins_counts, self.ins_wf + self.ins_wr,
                self.node_del_counts, self.del_len,
                self.del_wf + self.del_wr)

    def error_weight(self, base_terms: np.ndarray) -> float:
        """poa_getTotalErrorWeight given each node's disagreement weight:
        Poa._total_error_weight_py's float64 sums in its order, the
        per-node insert and delete sums by the same builtin sum."""
        ins = ((self.ins_wf + self.ins_wr) * self.ins_len).tolist()
        dels = ((self.del_wf + self.del_wr) * self.del_len).tolist()
        total = 0.0
        i = d = 0
        for b, ni, nd in zip(base_terms.tolist(),
                             self.node_ins_counts.tolist(),
                             self.node_del_counts.tolist()):
            total += b
            if ni:
                total += sum(ins[i:i + ni])
                i += ni
            if nd:
                total += sum(dels[d:d + nd])
                d += nd
        return total

    def nodes(self, poa) -> list:
        """The PoaNode / PoaInsert / PoaDelete objects of `poa`, with the
        repeat counts its ref_string holds now."""
        from margin_tpu_torch.polish.poa import PoaDelete, PoaInsert
        from margin_tpu_torch.rle import RleString

        def obs_lists(counts, cols):
            """All observation tuples in one zip, sliced per owner."""
            flat = list(zip(*(c.tolist() for c in cols)))
            out = []
            a = 0
            for c in counts.tolist():
                out.append(flat[a:a + c])
                a += c
            return out

        node_obs = obs_lists(self.node_obs_counts,
                             (self.obs_rn, self.obs_off, self.obs_wt))
        ins_obs = obs_lists(self.ins_obs_counts, self.ins_obs)
        del_obs = obs_lists(self.del_obs_counts, self.del_obs)
        ins_wf, ins_wr = self.ins_wf.tolist(), self.ins_wr.tolist()
        inserts = []
        b0 = 0
        for j, ln in enumerate(self.ins_len.tolist()):
            bases = self.ins_bases[b0:b0 + ln].tobytes().decode("ascii")
            pi = PoaInsert(RleString(bases,
                                     self.ins_counts[b0:b0 + ln].copy()),
                           ins_wf[j], ins_wr[j])
            pi.observations = ins_obs[j]
            inserts.append(pi)
            b0 += ln
        del_len = self.del_len.tolist()
        del_wf, del_wr = self.del_wf.tolist(), self.del_wr.tolist()
        deletes = []
        for j in range(len(del_len)):
            pd = PoaDelete(del_len[j], del_wf[j], del_wr[j])
            pd.observations = del_obs[j]
            deletes.append(pd)

        nodes = []
        ref = poa.ref_string
        ref_bases = ref.bases.upper()
        ref_counts = ref.counts.tolist()
        ins_at = del_at = 0
        nic = self.node_ins_counts.tolist()
        ndc = self.node_del_counts.tolist()
        for idx in range(self.n_nodes):
            base = "N" if idx == 0 else ref_bases[idx - 1]
            repeat = 1 if idx == 0 else ref_counts[idx - 1]
            node = poa._make_node(base, repeat, idx)
            node.observations = node_obs[idx]
            k = nic[idx]
            node.inserts = inserts[ins_at:ins_at + k]
            ins_at += k
            k = ndc[idx]
            node.deletes = deletes[del_at:del_at + k]
            del_at += k
            nodes.append(node)
        return nodes
