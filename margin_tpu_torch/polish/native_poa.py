"""ctypes binding for the native POA augmentation engine
(native/marginpoa.cc).

Counterpart of `margin_tpu/polish/native_poa.py`: poa_augment's run
grouping, left-shift normalization and observation bookkeeping
(poa.c:269-543) and poa_getConsensus run in C++, bit-identical to the
Python `Poa`; after all reads are augmented the serialized graph is
rebuilt into the ordinary `Poa`. The library is built from
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

    nodes = poa.nodes
    n_nodes = len(nodes)
    # node weight arrays are views into the shared accumulators; nodes[0]
    # is the 'N' prefix and nodes[1:] mirror ref_string (poa.py _make_node)
    bw = np.ascontiguousarray(poa._bw[:n_nodes], dtype=np.float64)
    rw = np.ascontiguousarray(poa._rw[:n_nodes], dtype=np.float64)
    max_rc = int(poa.max_repeat_count)
    node_syms = np.empty(n_nodes, dtype=np.int8)
    node_syms[0] = 4
    node_syms[1:] = seq_to_symbols(poa.ref_string.bases)
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
    del_len = np.asarray(del_len, dtype=np.int64)
    del_w = np.asarray(del_w, dtype=np.float64)

    out = ctypes.POINTER(ctypes.c_uint8)()
    nbytes = L.mpoa_consensus(
        n_nodes, bw, rw, max_rc, node_syms, node_rcs,
        ins_node_counts, ins_off, np.ascontiguousarray(ins_bases),
        ins_counts, ins_w,
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
        """Export and rebuild the Python Poa; frees the handle."""
        from margin_tpu_torch.polish.poa import Poa, PoaInsert, PoaDelete
        from margin_tpu_torch.rle import RleString

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

        buf = np.frombuffer(raw, dtype=np.uint8)
        pos = 0

        def i64s(count):
            nonlocal pos
            v = buf[pos:pos + count * 8].view(np.int64)
            pos += count * 8
            return v

        def f64s(count):
            nonlocal pos
            v = buf[pos:pos + count * 8].view(np.float64)
            pos += count * 8
            return v

        def obs_lists(counts_arr, total):
            """All observation tuples in one zip, sliced per owner."""
            rn = i64s(total).tolist()
            off = i64s(total).tolist()
            wt = f64s(total).tolist()
            flat = list(zip(rn, off, wt))
            out = []
            a = 0
            for c in counts_arr.tolist():
                out.append(flat[a:a + c])
                a += c
            return out

        (n_nodes, max_rc, n_obs, n_ins, ins_bases_pad, n_ins_counts,
         n_ins_obs, n_del, n_del_obs, _rsv) = i64s(10).tolist()
        poa = Poa.__new__(Poa)
        poa.ref_string = self.reference.copy()
        poa.max_repeat_count = max_rc
        poa._bw = f64s(n_nodes * 5).reshape(n_nodes, 5).copy()
        poa._rw = f64s(n_nodes * max_rc).reshape(n_nodes, max_rc).copy()

        node_obs_counts = i64s(n_nodes)
        obs_pos = pos  # flat (rn, off, wt) arrays start here
        node_obs = obs_lists(node_obs_counts, n_obs)
        # stash the flat per-node observation arrays: get_anchor_alignments
        # consumes them vectorized instead of re-walking 10^6+ observation
        # tuples per production chunk
        poa._flat_obs = (
            node_obs_counts.copy(),
            buf[obs_pos:obs_pos + n_obs * 8].view(np.int64).copy(),
            buf[obs_pos + n_obs * 8:obs_pos + 2 * n_obs * 8]
            .view(np.int64).copy(),
            buf[obs_pos + 2 * n_obs * 8:obs_pos + 3 * n_obs * 8]
            .view(np.float64).copy())
        node_ins_counts = i64s(n_nodes)
        ins_len = i64s(n_ins)
        ins_bases = buf[pos:pos + ins_bases_pad]
        pos += ins_bases_pad
        ins_counts = i64s(n_ins_counts)
        ins_wf = f64s(n_ins).tolist()
        ins_wr = f64s(n_ins).tolist()
        ins_obs_counts = i64s(n_ins)
        ins_obs = obs_lists(ins_obs_counts, n_ins_obs)
        node_del_counts = i64s(n_nodes)
        del_len = i64s(n_del).tolist()
        del_wf = f64s(n_del).tolist()
        del_wr = f64s(n_del).tolist()
        del_obs_counts = i64s(n_del)
        del_obs = obs_lists(del_obs_counts, n_del_obs)

        inserts = []
        b0 = c0 = 0
        for j, ln in enumerate(ins_len.tolist()):
            bases = ins_bases[b0:b0 + ln].tobytes().decode("ascii")
            pi = PoaInsert(RleString(bases, ins_counts[c0:c0 + ln].copy()),
                           ins_wf[j], ins_wr[j])
            pi.observations = ins_obs[j]
            inserts.append(pi)
            b0 += ln
            c0 += ln
        deletes = []
        for j in range(n_del):
            pd = PoaDelete(int(del_len[j]), del_wf[j], del_wr[j])
            pd.observations = del_obs[j]
            deletes.append(pd)

        nodes = []
        ref = self.reference
        ref_bases = ref.bases.upper()
        ins_at = del_at = 0
        nic = node_ins_counts.tolist()
        ndc = node_del_counts.tolist()
        for idx in range(n_nodes):
            base = "N" if idx == 0 else ref_bases[idx - 1]
            if base not in "ACGT":
                base = "N"
            repeat = 1 if idx == 0 else int(ref.counts[idx - 1])
            node = poa._make_node(base, repeat, idx)
            node.observations = node_obs[idx]
            k = nic[idx]
            node.inserts = inserts[ins_at:ins_at + k]
            ins_at += k
            k = ndc[idx]
            node.deletes = deletes[del_at:del_at + k]
            del_at += k
            nodes.append(node)
        poa.nodes = nodes
        return poa
