"""ctypes bindings for the native marginio engine (native/marginio.cc).

Falls back gracefully: `lib()` returns None when the shared library is not
built, and callers use the pure-Python path."""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np

_LIB = None
_TRIED = False


def lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    from margin_tpu_torch import _ext
    L = _ext.native_lib("marginio")
    if L is not None:
        _LIB = bind(L)
    return _LIB


def bind(L: ctypes.CDLL) -> ctypes.CDLL:
    """Declare marginio's C entry points on the loaded library L."""
    L.mio_open.restype = ctypes.c_void_p
    L.mio_open.argtypes = [ctypes.c_char_p]
    L.mio_close.argtypes = [ctypes.c_void_p]
    L.mio_n_refs.argtypes = [ctypes.c_void_p]
    L.mio_ref_name.restype = ctypes.c_char_p
    L.mio_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    L.mio_ref_len.restype = ctypes.c_int64
    L.mio_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    L.mio_header_text.restype = ctypes.c_char_p
    L.mio_header_text.argtypes = [ctypes.c_void_p]
    L.mio_scan.restype = ctypes.c_int64
    L.mio_scan.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    L.mio_iter_region.restype = ctypes.c_void_p
    L.mio_iter_region.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int64, ctypes.c_int64]
    L.mio_iter_next.restype = ctypes.c_int64
    L.mio_iter_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    L.mio_iter_destroy.argtypes = [ctypes.c_void_p]
    L.mio_fetch_region_all.restype = ctypes.c_int64
    L.mio_fetch_region_all.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))]
    L.mio_buf_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    L.mio_buf_free.restype = None
    L.mio_sizes_free.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    L.mio_sizes_free.restype = None
    L.mio_write_haplotagged.restype = ctypes.c_int
    L.mio_write_haplotagged.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int32), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int64)]
    L.mio_extract_substrings.restype = ctypes.c_void_p
    L.mio_extract_substrings.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    for fn in ("mio_extract_n_reads", "mio_extract_n_pairs",
               "mio_extract_blob_len", "mio_extract_names_len"):
        getattr(L, fn).restype = ctypes.c_int64
        getattr(L, fn).argtypes = [ctypes.c_void_p]
    L.mio_extract_fill.restype = None
    L.mio_extract_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64), ctypes.c_char_p, ctypes.c_char_p]
    L.mio_extract_free.restype = None
    L.mio_extract_free.argtypes = [ctypes.c_void_p]
    L.mio_rle_dedup.restype = ctypes.c_int64
    L.mio_rle_dedup.argtypes = [np.ctypeslib.ndpointer(np.int64),
                                ctypes.c_int64, ctypes.c_int64]
    return L


class NativeBam:
    """Thin wrapper over the native BAM handle (of `engine`, a library
    from `bind`, or the port's own build)."""

    def __init__(self, path: str, engine: Optional[ctypes.CDLL] = None):
        L = engine or lib()
        if L is None:
            raise RuntimeError("native marginio library unavailable")
        self._lib = L
        self._h = L.mio_open(path.encode())
        if not self._h:
            raise IOError(f"mio_open failed for {path}")
        n = L.mio_n_refs(self._h)
        self.ref_names = [L.mio_ref_name(self._h, i).decode() for i in range(n)]
        self.ref_lengths = [L.mio_ref_len(self._h, i) for i in range(n)]
        self.header_text = L.mio_header_text(self._h).decode(errors="replace")

    def close(self):
        if self._h:
            self._lib.mio_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def scan(self):
        """Full scan returning packed arrays: dict of numpy arrays + names
        list. One native pass; no per-record Python."""
        cap = 1 << 16
        names_cap = 1 << 22
        while True:
            tid = np.empty(cap, np.int32)
            pos = np.empty(cap, np.int64)
            flag = np.empty(cap, np.int32)
            mapq = np.empty(cap, np.int32)
            alen = np.empty(cap, np.int64)
            ssc = np.empty(cap, np.int64)
            esc = np.empty(cap, np.int64)
            name_off = np.empty(cap, np.int64)
            names_buf = ctypes.create_string_buffer(names_cap)
            n = self._lib.mio_scan(self._h, tid, pos, flag, mapq, alen, ssc,
                                   esc, name_off, names_buf, names_cap, cap)
            if n == -2:
                cap *= 4
                continue
            if n == -3:
                names_cap *= 4
                continue
            if n < 0:
                raise IOError(f"mio_scan failed: {n}")
            blob = names_buf.raw
            names = [blob[int(o):blob.index(b"\0", int(o))].decode()
                     for o in name_off[:n]]
            return dict(tid=tid[:n], pos=pos[:n], flag=flag[:n], mapq=mapq[:n],
                        aligned_len=alen[:n], start_sc=ssc[:n], end_sc=esc[:n],
                        names=names)

    def extract_substrings(self, tid: int, fetch_start: int, fetch_end: int,
                           chunk_overlap_start: int, chunk_start: int,
                           chunk_end: int, var_pos, win_start, win_end,
                           mapq_thresh: int, include_secondary: bool,
                           include_supplementary: bool, keep_filtered: bool):
        """Native variant-substring extraction (one C call per chunk pass).
        Returns dict of packed arrays (names blob, per-read flags/lengths,
        per-pair read/var indices + substring/qual blobs) or None on
        failure; margin_tpu_torch.phase.readextract assembles the objects."""
        L = self._lib
        var_pos = np.ascontiguousarray(var_pos, dtype=np.int64)
        win_start = np.ascontiguousarray(win_start, dtype=np.int64)
        win_end = np.ascontiguousarray(win_end, dtype=np.int64)
        h = L.mio_extract_substrings(
            self._h, tid, fetch_start, fetch_end, chunk_overlap_start,
            chunk_start, chunk_end, var_pos, win_start, win_end,
            len(var_pos), int(mapq_thresh), int(include_secondary),
            int(include_supplementary), int(keep_filtered))
        if not h:
            return None
        try:
            n_reads = L.mio_extract_n_reads(h)
            n_pairs = L.mio_extract_n_pairs(h)
            blob_len = L.mio_extract_blob_len(h)
            names_len = L.mio_extract_names_len(h)
            names = ctypes.create_string_buffer(max(names_len, 1))
            subs = ctypes.create_string_buffer(max(blob_len, 1))
            quals = ctypes.create_string_buffer(max(blob_len, 1))
            name_off = np.empty(max(n_reads, 1), np.int64)
            rflags = np.empty(max(n_reads, 1), np.int32)
            rlen = np.empty(max(n_reads, 1), np.int64)
            pair_read = np.empty(max(n_pairs, 1), np.int64)
            pair_var = np.empty(max(n_pairs, 1), np.int64)
            sub_off = np.empty(max(n_pairs, 1), np.int64)
            sub_len = np.empty(max(n_pairs, 1), np.int64)
            L.mio_extract_fill(h, names, name_off, rflags, rlen, pair_read,
                               pair_var, sub_off, sub_len, subs, quals)
        finally:
            L.mio_extract_free(h)
        return dict(n_reads=n_reads, n_pairs=n_pairs,
                    names=names.raw[:names_len], name_off=name_off[:n_reads],
                    rflags=rflags[:n_reads], rlen=rlen[:n_reads],
                    pair_read=pair_read[:n_pairs],
                    pair_var=pair_var[:n_pairs], sub_off=sub_off[:n_pairs],
                    sub_len=sub_len[:n_pairs], subs=subs.raw[:blob_len],
                    quals=np.frombuffer(quals.raw[:blob_len], np.uint8))

    def fetch_raw(self, tid: int, start: int, end: int):
        """Yield raw record payload bytes overlapping [start, end).

        One native call fetches the whole region (concatenated payloads +
        size table); the per-record iterator round-trip through ctypes
        dominated the readextract profile at ~0.2 ms/record."""
        out = ctypes.POINTER(ctypes.c_uint8)()
        sizes = ctypes.POINTER(ctypes.c_int64)()
        n = self._lib.mio_fetch_region_all(self._h, tid, start, end,
                                           ctypes.byref(out),
                                           ctypes.byref(sizes))
        if n < 0:
            raise IOError("mio_fetch_region_all failed")
        try:
            if n == 0:
                return
            sz = np.ctypeslib.as_array(sizes, shape=(n,))
            blob = ctypes.string_at(out, int(sz.sum()))
            off = 0
            for s in sz.tolist():
                yield blob[off:off + s]
                off += s
        finally:
            self._lib.mio_buf_free(out)
            self._lib.mio_sizes_free(sizes)


def write_haplotagged_native(bam_in: str, bam_out: str, tags: Dict[str, int],
                             tid: int = -1, start: int = -1, end: int = -1,
                             include_secondary=False, include_supplementary=False,
                             engine: Optional[ctypes.CDLL] = None):
    """Native haplotagged-BAM rewrite. tags: read name -> 1/2.
    Returns (h1, h2, h0) counts or None if native lib unavailable."""
    L = engine or lib()
    if L is None:
        return None
    names = list(tags.keys())
    blob = b"\0".join(n.encode() for n in names) + b"\0"
    haps = np.array([tags[n] for n in names], dtype=np.int32)
    counts = np.zeros(3, dtype=np.int64)
    ret = L.mio_write_haplotagged(bam_in.encode(), bam_out.encode(), blob,
                                  haps, len(names), tid, start, end,
                                  1 if include_secondary else 0,
                                  1 if include_supplementary else 0, counts)
    if ret != 0:
        raise IOError(f"mio_write_haplotagged failed: {ret}")
    return int(counts[0]), int(counts[1]), int(counts[2])
