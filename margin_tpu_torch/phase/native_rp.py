"""ctypes binding for the native stRPHmm engine (native/marginrp.cc).

The per-chunk read-partition pipeline — tiling-path construction, the
recursive cross-product merge tree with FB + pruning at every node
(coordination.c:263-409, hmm.c:534-1163), and the final fused
forward-backward — is thousands of tiny column/merge operations: host
pointer-chasing the Python oracle (margin_tpu/phase/rphmm.py) spends ~1.4 s
per 100 kb chunk on. The C++ engine mirrors the oracle
operation-for-operation and returns the final fused HMM's full state, which
this module reconstructs into the ordinary Python `RPHmm` so traceback,
genome-fragment construction and refinement run unchanged.

When the engine does not build, the Python oracle runs (bit-identical
under maxNotSumTransitions).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOAD_LOCK = threading.Lock()

_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_U16P = np.ctypeslib.ndpointer(dtype=np.uint16, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


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
    L = _ext.native_lib("marginrp")
    if L is None:
        return None
    L.mrp_phase.restype = ctypes.c_int64
    L.mrp_phase.argtypes = [
        ctypes.c_int64, _I32P, _I64P, _U16P, _U16P, _I64P,   # reference
        ctypes.c_int64, ctypes.c_int64, _I32P, _I32P, _I64P,  # seqs
        _U8P, _I64P, _I32P,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_double,      # params
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    L.mrp_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    L.mrp_free.restype = None
    _LIB = L
    return _LIB


class _Parser:
    def __init__(self, raw: bytes):
        self.buf = np.frombuffer(raw, dtype=np.uint8)
        self.pos = 0

    def i64(self) -> int:
        v = int(self.buf[self.pos:self.pos + 8].view(np.int64)[0])
        self.pos += 8
        return v

    def f64(self) -> float:
        v = float(self.buf[self.pos:self.pos + 8].view(np.float64)[0])
        self.pos += 8
        return v

    def i32s(self) -> np.ndarray:
        n = self.i64()
        v = self.buf[self.pos:self.pos + n * 4].view(np.int32).copy()
        self.pos += (n * 4 + 7) & ~7
        return v

    def arr(self, n: int, dtype) -> np.ndarray:
        nbytes = n * np.dtype(dtype).itemsize
        v = self.buf[self.pos:self.pos + nbytes].view(dtype).copy()
        self.pos += nbytes
        return v


def phase_fused_hmm(fwd_seqs: List, rev_seqs: List, ref, params, device):
    """Run the native per-chunk pipeline; returns the fused `RPHmm` after
    the final forward-backward (include_ancestor=True), or None when the
    native library is unavailable. Mirrors:

        tp_f = get_rp_hmms(fwd, device); tp_r = get_rp_hmms(rev, device)
        merged = merge_two_tiling_paths(tp_f, tp_r, include_ancestor=False)
        hmm = fuse_tiling_path(merged); hmm.forward_backward(True)
    """
    L = lib()
    if L is None:
        return None
    from margin_tpu_torch.phase import rphmm

    seqs = list(fwd_seqs) + list(rev_seqs)
    if not seqs:
        return None

    n_sites = ref.length
    allele_number = np.array([s.allele_number for s in ref.sites],
                             dtype=np.int32)
    allele_offset = ref.allele_offsets().astype(np.int64)
    priors = np.concatenate(
        [s.allele_prior_log_probs for s in ref.sites]).astype(np.uint16) \
        if n_sites else np.zeros(0, np.uint16)
    subs_list = [s.substitution_log_probs.ravel() for s in ref.sites]
    subs = (np.concatenate(subs_list).astype(np.uint16)
            if subs_list else np.zeros(0, np.uint16))
    sub_offset = np.zeros(n_sites + 1, dtype=np.int64)
    np.cumsum([s.allele_number * s.allele_number for s in ref.sites],
              out=sub_offset[1:])

    ps_ref_start = np.array([p.ref_start for p in seqs], dtype=np.int32)
    ps_length = np.array([p.length for p in seqs], dtype=np.int32)
    ps_allele_offset = np.array([p.allele_offset for p in seqs],
                                dtype=np.int64)
    probs_list = [np.ascontiguousarray(p.probs, dtype=np.uint8)
                  for p in seqs]
    ps_probs = (np.concatenate(probs_list) if probs_list
                else np.zeros(0, np.uint8))
    ps_probs_offset = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(a) for a in probs_list], out=ps_probs_offset[1:])
    # dense read-id rank: stands in for the oracle's string comparison
    ids = sorted({p.read_id for p in seqs})
    rank_of = {rid: i for i, rid in enumerate(ids)}
    ps_rank = np.array([rank_of[p.read_id] for p in seqs], dtype=np.int32)

    out = ctypes.POINTER(ctypes.c_uint8)()
    n = L.mrp_phase(
        n_sites, allele_number, allele_offset, priors, subs, sub_offset,
        len(fwd_seqs), len(seqs), ps_ref_start, ps_length, ps_allele_offset,
        ps_probs, ps_probs_offset, ps_rank,
        params.maxPartitionsInAColumn, params.minPartitionsInAColumn,
        params.minPosteriorProbabilityForPartition,
        1 if params.includeInvertedPartitions else 0,
        1 if params.maxNotSumTransitions else 0,
        1,  # final FB include_ancestor=True (bubbleGraph.c:2752)
        ctypes.byref(out))
    if n < 0:
        return None
    try:
        raw = ctypes.string_at(out, n)
    finally:
        L.mrp_free(out)

    p = _Parser(raw)
    n_cols = p.i64()
    ref_start = p.i64()
    ref_length = p.i64()
    fwd_lp = p.f64()
    bwd_lp = p.f64()
    hmm_seq_idx = p.i32s()
    columns = []
    for _ in range(n_cols):
        c_start = p.i64()
        c_len = p.i64()
        c_seqs = [seqs[i] for i in p.i32s()]
        n_cells = p.i64()
        parts = p.arr(n_cells, np.uint64)
        fwd = p.arr(n_cells, np.float64)
        bwd = p.arr(n_cells, np.float64)
        emis = p.arr(n_cells, np.float64)
        total = p.f64()
        col = rphmm.Column(c_start, c_len, c_seqs, parts)
        col.forward = fwd
        col.backward = bwd
        col.emission = emis
        col.total_log_prob = total
        columns.append(col)
    merges = []
    for _ in range(n_cols - 1):
        mask_from = p.i64() & 0xFFFFFFFFFFFFFFFF
        mask_to = p.i64() & 0xFFFFFFFFFFFFFFFF
        n_cells = p.i64()
        fp = p.arr(n_cells, np.uint64)
        tp = p.arr(n_cells, np.uint64)
        m = rphmm.MergeColumn(mask_from, mask_to)
        m.set_cells(fp, tp)
        merges.append(m)

    hmm = rphmm.RPHmm(ref, ref_start, ref_length,
                      [seqs[i] for i in hmm_seq_idx], columns, merges,
                      params, device)
    hmm.forward_log_prob = fwd_lp
    hmm.backward_log_prob = bwd_lp
    return hmm
