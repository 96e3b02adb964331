"""Batched banded pair-HMM forward-backward with posterior extraction.

Counterpart of the part of `margin_tpu/ops/banded.py` that the port's
paths reach: `BandGeometry` (:40-125), `_bucket_w`
(:126), `get_split_points` (:534), `banded_posteriors_split` (:567),
`banded_posteriors` (:776), `banded_expectations` (:1910),
`split_sub_items` (:1404), `_true_band_cells`
(:1465), `_item_geom` (:1473), the flat posterior extraction
(`_device_extract_flat` / `_unpack_extract` / `_store_pack_results`,
:704-773 and :974-1000) and `banded_posteriors_many` (:1637-1798).
Parity: getPosteriorProbsWithBanding (pairwiseAligner.c:706-844).

Band geometry: cell k of diagonal d is xmy = xmyL[d] + 2k, with
x = (d+xmy)/2, y = (d-xmy)/2.

Routing, as the JAX package routes on an accelerator
(banded.py:1140-1183), a property of the item alone: an item whose
smoothed band is wider than 128 cells, or with more than 2^22 diagonals,
goes to the host C++ engine (native/marginfb.cc); an item with more than
SEG_MIN_D diagonals (lx + ly + 1), or whose own grids would not fit
cuda_banded.FB_GRID_BUDGET_BYTES, to the segmented kernels (K3); every
other item to the monolithic pack kernels (K2). Packs hold at most 128
problems of one (width bucket, RLE) kind. The JAX package's
`_bucket_dpad(d) > 16384` is exactly `d > 16384`. Three TPU workarounds
are not carried over: the launch-latency threshold `_device_min_cells`,
the 6144-diagonal floor and the diagonal bucketing `_bucket_dpad` — a
CUDA block walks each problem's own depth. The single-item
`banded_posteriors`, which the JAX package runs on its XLA scan (K4),
takes the same pack route here. On a CUDA device a wide band with no
host engine raises (nothing carries on on the CPU twins); on the CPU the
twins take it.

Concurrent calls (chunk threads, the score server's handlers) merge in
the cross-chunk funnel `_FbFunnel` (banded.py:1309-1401; off with
MARGIN_TPU_FB_FUNNEL=0), whose dispatcher runs the pack loop `_PackRun`
over the union of their items; results do not depend on it. In a
process worker (`parallel/ipc.py`) the worker branch (banded.py:1656-1728)
solves on its own host engine exactly the items `_route` sends to the
host and ships the rest to the parent, so process mode routes every item
as thread mode does; the JAX package's worker also keeps bands below
`_device_min_cells` local, a threshold this port does not have (above).
A pack on the card goes through K2-fwd and K2-bwd's WORDS instance, which
emits the extraction words itself (no posterior grid); `extract_packed`,
the torch-op extraction, is the WORDS instance's plain twin's second
half.

The transition expectations (`banded_expectations(_many)`, Baum-Welch EM)
take K2-fwd and then K4 for any band up to 128 cells wide, whatever its
depth, and K5-fwd and then K5-exp (csrc/banded_wide.cu) for a wider one;
the plain twins on the CPU.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from margin_tpu_torch.ops import cuda_banded
from margin_tpu_torch.testing.oracle import build_band

MATCH, GAPX, GAPY = 0, 1, 2
PACK_MAX_B = 128  # the extraction word's 9-bit tag holds 3*128+2
# items with more diagonals take the segmented kernels (banded.py:882-889)
SEG_MIN_D = 16384
MAX_DIAGONALS = 1 << 22  # the extraction word's 22-bit diagonal


@dataclass
class BandGeometry:
    """Host-side band description, padded to (D+1, W)."""
    lx: int
    ly: int
    d_pad: int          # padded diagonal count (>= lx+ly+1)
    w_pad: int          # padded band width
    xmy_l: np.ndarray   # (d_pad,) int32 storage base: cell k holds xmy_l+2k
    widths: np.ndarray  # (d_pad,) int32 exclusive upper valid k
    x_base: np.ndarray  # (d_pad,) x index of consumed char at k=0: (d+xmyL)/2 - 1
    y_base: np.ndarray  # (d_pad,) y index of consumed char at k=0: (d-xmyL)/2 - 1
    pm1: bool = False   # storage base moves by exactly +-1 per diagonal
    k_lo: np.ndarray | None = None  # (d_pad,) first valid k (None -> 0)

    @staticmethod
    def build(anchors, lx: int, ly: int, expansion: int,
              d_pad: int | None = None, w_pad: int | None = None,
              dynamic: bool = False, smooth: bool = False) -> "BandGeometry":
        band = build_band([] if anchors is None else anchors, lx, ly,
                          expansion, dynamic=dynamic)
        d_real = lx + ly + 1
        lo = band[:, 0].astype(np.int64)
        hi = band[:, 1].astype(np.int64)
        if smooth and d_real > 1:
            # The storage base s steps by exactly +-1 per diagonal, so every
            # dependency between diagonals is a neighbour k-1, k or k+1:
            # s = the maximal 1-Lipschitz minorant of the band's lower
            # bound, s[d] = min_d' (lo[d'] + |d-d'|). Valid cells keep the
            # exact reference band via [k_lo, widths) masking.
            d_r = np.arange(d_real)
            fwd_min = np.minimum.accumulate(lo - d_r) + d_r
            bwd_min = np.minimum.accumulate((lo + d_r)[::-1])[::-1] - d_r
            s = np.minimum(fwd_min, bwd_min)
            k_lo_real = (lo - s) // 2
            widths_real = ((hi - s) // 2 + 1).astype(np.int32)
            base = s
        else:
            k_lo_real = np.zeros(d_real, dtype=np.int64)
            widths_real = ((hi - lo) // 2 + 1).astype(np.int32)
            base = lo
        if d_pad is None:
            d_pad = d_real
        if w_pad is None:
            w_pad = int(widths_real.max())
        xmy_l = np.zeros(d_pad, dtype=np.int32)
        w = np.zeros(d_pad, dtype=np.int32)
        k_lo = np.zeros(d_pad, dtype=np.int32)
        xmy_l[:d_real] = base
        w[:d_real] = widths_real
        k_lo[:d_real] = k_lo_real
        d_idx = np.arange(d_pad, dtype=np.int64)
        x_base = ((d_idx + xmy_l) // 2 - 1).astype(np.int32)
        y_base = ((d_idx - xmy_l) // 2 - 1).astype(np.int32)
        steps = np.abs(np.diff(base)) if d_real > 1 else np.zeros(1)
        pm1 = bool(steps.max(initial=0) <= 1)
        return BandGeometry(lx, ly, d_pad, w_pad, xmy_l, w, x_base, y_base,
                            pm1, k_lo if k_lo.any() else None)


def _bucket_w(w: int) -> int:
    """Band-width storage buckets of the pack kernels."""
    for b in (16, 32, 64):
        if w <= b:
            return b
    return 128


def _true_band_cells(geom: BandGeometry) -> int:
    """Exact band cell count (independent of storage smoothing)."""
    w = geom.widths.astype(np.int64)
    if geom.k_lo is not None:
        w = w - geom.k_lo
    return int(np.maximum(w, 0).sum())


def _item_geom(it: dict, expansion: int, dynamic: bool) -> BandGeometry:
    """Smoothed (unpadded) band geometry for one item, cached on the item
    dict under `_geom`."""
    geom = it.get("_geom")
    if geom is None:
        geom = BandGeometry.build(it["anchors"], len(it["x_sym"]),
                                  len(it["y_sym"]), expansion,
                                  dynamic=dynamic, smooth=True)
        it["_geom"] = geom
    return geom


class RouteStats:
    """How many banded items took each route, for reports."""

    def __init__(self):
        self._lock = threading.Lock()
        self.pack_items = 0   # the pack kernels (K2, or their plain twins)
        self.host_items = 0   # the host engine (native/marginfb.cc)
        self.packs = 0
        self.seg_items = 0    # the segmented kernels (K3, or their twins)
        self.seg_packs = 0

    def add(self, pack_items=0, host_items=0, packs=0, seg_items=0,
            seg_packs=0):
        with self._lock:
            self.pack_items += pack_items
            self.host_items += host_items
            self.packs += packs
            self.seg_items += seg_items
            self.seg_packs += seg_packs

    def reset(self):
        with self._lock:
            self.pack_items = self.host_items = self.packs = 0
            self.seg_items = self.seg_packs = 0


ROUTES = RouteStats()


# ---------------------------------------------------------------------------
# posterior extraction
# ---------------------------------------------------------------------------

def extract_packed(post: torch.Tensor, totals: torch.Tensor,
                   pack: cuda_banded.BandPack, threshold: float):
    """Flat batched addPosteriorProb extraction (`_device_extract_flat` +
    `_device_extract_packed`, banded.py:704-756) on the pack's device:
    every cell with posterior >= threshold, compacted into two int32 words
    per pair, lo = floor(min(p,1)*1e7) | k << 24, hi = d | (3b+s) << 22,
    fused with the count and the bit-cast totals into ONE int32 tensor
    [count, totals, lo words, hi words]. gapX pairs need x > 0, gapY pairs
    y > 0, matches both."""
    W = pack.W
    prob, diag, xb, yb = cuda_banded.derive_geom(pack)
    k = torch.arange(W, device=post.device)[None, :]
    x_ok = (xb[:, None] + 1 + k) > 0                        # (rows, W)
    y_ok = (yb[:, None] + 1 - k) > 0
    sel = post >= threshold
    sel[:, MATCH] &= x_ok & y_ok
    sel[:, GAPX] &= x_ok
    sel[:, GAPY] &= y_ok
    r, s, kk = torch.nonzero(sel, as_tuple=True)
    # the words hold k < 128, 3b+s < 511 and d < 2^22 (banded.py:713-720)
    if r.numel() and not (int(kk.max()) < 128 and pack.B * 3 < 511
                          and int(diag[r].max()) < (1 << 22)):
        raise ValueError("pairs exceed the extraction word's bit budget")
    probs = torch.floor(torch.clamp(post[r, s, kk], max=1.0)
                        * 10_000_000).to(torch.int32)
    tag = (prob[r] * 3 + s).to(torch.int32)
    lo = probs | (kk.to(torch.int32) << 24)
    hi = diag[r].to(torch.int32) | (tag << 22)
    count = torch.tensor([lo.numel()], dtype=torch.int32, device=post.device)
    return torch.cat([count, totals.contiguous().view(torch.int32), lo, hi])


def _unpack_extract(lo: np.ndarray, hi: np.ndarray, xb_np: np.ndarray,
                    yb_np: np.ndarray, geo_off: np.ndarray):
    """Host-side unpack of the extraction words: returns
    (vals, pxs, pys, tags). xb_np / yb_np are per grid row."""
    vals = (lo & 0xFFFFFF).astype(np.int64)
    k = (lo >> 24) & 0x7F
    d = (hi & 0x3FFFFF).astype(np.int64)
    tags = (hi >> 22).astype(np.int64)
    rows = geo_off[tags // 3] + d
    pxs = xb_np[rows] + k          # x_pos - 1 = x_base + 1 + k - 1
    pys = yb_np[rows] - k          # y_pos - 1 = y_base + 1 - k - 1
    return vals, pxs, pys, tags


def _store_pack_results(refs, packed: np.ndarray, pack, t_wait: float):
    """Unpack one pack's fused readback, sort into per-(problem, state)
    runs ordered by (x, y), and store ((matches, gapx, gapy), total) per
    item."""
    from margin_tpu_torch.parallel.executor import DEVICE_STATS
    n = len(refs)
    total = int(packed[0])
    totals_np = packed[1:1 + n].view(np.float32).astype(np.float64)
    lo = packed[1 + n:1 + n + total]
    hi = packed[1 + n + total:1 + n + 2 * total]
    DEVICE_STATS.add(n, pack.n_rows * pack.W, t_wait)
    xb_np = np.concatenate([g.x_base[:g.lx + g.ly + 1] for g in pack.geoms])
    yb_np = np.concatenate([g.y_base[:g.lx + g.ly + 1] for g in pack.geoms])
    geo_off = pack.geo_off.cpu().numpy()
    vals, pxs, pys, tags = _unpack_extract(lo, hi, xb_np, yb_np, geo_off)
    order = np.lexsort((pys, pxs, tags))
    vals, pxs, pys, tags = (a[order] for a in (vals, pxs, pys, tags))
    bounds = np.searchsorted(tags, np.arange(3 * n + 1))
    for k, (out, idx) in enumerate(refs):
        res = []
        for s in range(3):
            a, b = bounds[3 * k + s], bounds[3 * k + s + 1]
            res.append(np.stack([vals[a:b], pxs[a:b], pys[a:b]],
                                axis=1).astype(np.int64))
        out[idx] = (tuple(res), float(totals_np[k]))


# ---------------------------------------------------------------------------
# routing and packs
# ---------------------------------------------------------------------------

def _solve_native_items(tables, items, expansion, threshold, use_lut,
                        dynamic):
    """Host C++ banded FB (native/marginfb.cc) over a list of items,
    threaded (each call releases the GIL) on MARGIN_TPU_NATIVE_FB_THREADS
    threads, every core by default (a process worker is given its share)."""
    from margin_tpu_torch.ops import native_fb

    def one(i):
        return native_fb.posteriors_item(tables, items[i], expansion,
                                         threshold, use_lut, dynamic)

    cap = int(os.environ.get("MARGIN_TPU_NATIVE_FB_THREADS", "0")) \
        or os.cpu_count() or 1
    with ThreadPoolExecutor(max_workers=max(1, min(cap, len(items)))) as ex:
        return list(ex.map(one, range(len(items))))


def _packs(entries, w_pad: int, seg: bool):
    """Cut (lx+ly, item index) entries of one bucket into packs of at most
    PACK_MAX_B problems, deepest first so problems of like depth share a
    pack; monolithic packs also keep their grids within the memory budget
    (every item there fits it alone, see _route)."""
    entries = sorted(entries, key=lambda e: -e[0])
    pack, rows = [], 0
    for d, ref in entries:
        need = d + 1
        if pack and (len(pack) == PACK_MAX_B or (not seg and (
                cuda_banded.grid_bytes(rows + need, w_pad)
                > cuda_banded.FB_GRID_BUDGET_BYTES))):
            yield pack
            pack, rows = [], 0
        pack.append(ref)
        rows += need
    if pack:
        yield pack


def _route(geom: BandGeometry) -> str:
    """'host', 'seg' or 'pack' for one item (see the module docstring)."""
    d = geom.lx + geom.ly + 1
    if geom.w_pad > 128 or d > MAX_DIAGONALS:
        return "host"
    if d > SEG_MIN_D or cuda_banded.grid_bytes(
            d, _bucket_w(geom.w_pad)) > cuda_banded.FB_GRID_BUDGET_BYTES:
        return "seg"
    return "pack"


class _ItemRef:
    """One item of a call, where its result goes, and the funnel request it
    belongs to (None for a direct call)."""
    __slots__ = ("item", "out", "idx", "req")

    def __init__(self, item, out, idx, req=None):
        self.item = item
        self.out = out
        self.idx = idx
        self.req = req


class _PackRun:
    """Solves a stream of items. Each is routed by _route: wide bands go to
    the host engine on a side thread while the device solves packs of one
    (width bucket, RLE, segmented) kind, the fullest bucket first and its
    deepest problems first (_packs). `drain(refill)` takes more items from
    `refill()` between packs; `complete(ref)` runs once a result is
    stored."""

    def __init__(self, tables, expansion, threshold, use_lut, dynamic,
                 complete=None):
        self.tables = tables
        self.expansion = expansion
        self.threshold = threshold
        self.use_lut = use_lut
        self.dynamic = dynamic
        self.complete = complete
        self.buckets: dict = {}     # (w_pad, use_rle, seg) -> [(lx+ly, ref)]
        self.host_jobs: list = []   # (future, [refs]) on the host engine
        self._pool = None

    def _store(self, ref, result):
        ref.out[ref.idx] = result
        if self.complete is not None:
            self.complete(ref)

    def add(self, refs):
        from margin_tpu_torch.ops import native_fb
        host = []
        for ref in refs:
            it = ref.item
            lx, ly = len(it["x_sym"]), len(it["y_sym"])
            if lx + ly == 0:
                empty = np.zeros((0, 3), dtype=np.int64)
                self._store(ref, ((empty, empty, empty), 0.0))
                continue
            geom = _item_geom(it, self.expansion, self.dynamic)
            route = _route(geom)
            if route == "host":
                host.append(ref)
                continue
            use_rle = (it.get("rep_x") is not None
                       and self.tables.repeat is not None)
            self.buckets.setdefault(
                (_bucket_w(geom.w_pad), use_rle, route == "seg"),
                []).append((lx + ly, ref))
        if not host:
            return
        if native_fb.lib() is not None:
            # wide bands run on the host engine while the device solves
            # the packs
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=1)
            self.host_jobs.append((self._pool.submit(
                _solve_native_items, self.tables, [r.item for r in host],
                self.expansion, self.threshold, self.use_lut, self.dynamic),
                host))
        elif _on_card(self.tables):
            raise RuntimeError(
                f"the posteriors of {len(host)} bands wider than 128 "
                "cells need the host banded engine (native/marginfb.cc, "
                "margin_tpu_torch/_build/libmarginfb.so), which did not "
                f"build or load ({K5_ITEM}: wide posteriors stay on the "
                "host)")
        else:
            # on the CPU without the host engine the plain twins take the
            # wide bands, as the JAX package's pure-XLA scan does there
            for ref in host:
                use_rle = (ref.item.get("rep_x") is not None
                           and self.tables.repeat is not None)
                self._solve([ref], _round8(ref.item["_geom"].w_pad),
                            use_rle, False)

    def _solve(self, refs, w_pad, use_rle, seg):
        items = [r.item for r in refs]
        (_solve_seg_pack if seg else _solve_pack)(
            self.tables, items, [it["_geom"] for it in items], w_pad,
            use_rle, self.expansion, self.use_lut, self.dynamic,
            self.threshold, [(r.out, r.idx) for r in refs])
        if self.complete is not None:
            for r in refs:
                self.complete(r)

    def drain(self, refill=None):
        """Launch packs until no bucket is left, absorbing what `refill()`
        returns before each; then collect the host engine's results."""
        try:
            while True:
                if refill is not None:
                    self.add(refill())
                if not self.buckets:
                    break
                key = max(self.buckets, key=lambda k: len(self.buckets[k]))
                w_pad, use_rle, seg = key
                entries = sorted(self.buckets.pop(key), key=lambda e: -e[0])
                pack = next(_packs(entries, w_pad, seg))
                if len(entries) > len(pack):
                    self.buckets[key] = entries[len(pack):]
                self._solve(pack, w_pad, use_rle, seg)
                if seg:
                    ROUTES.add(seg_items=len(pack), seg_packs=1)
                else:
                    ROUTES.add(pack_items=len(pack), packs=1)
        finally:
            jobs, self.host_jobs = self.host_jobs, []
            try:
                for fut, refs in jobs:
                    for ref, r in zip(refs, fut.result()):
                        self._store(ref, r)
                    ROUTES.add(host_items=len(refs))
            finally:
                if self._pool is not None:
                    self._pool.shutdown()
                    self._pool = None


class _FbRequest:
    __slots__ = ("key", "items", "results", "remaining", "done", "error")

    def __init__(self, key, items):
        self.key = key
        self.items = items
        self.results = [None] * len(items)
        self.remaining = len(items)
        self.done = False
        self.error = None


class _FbFunnel:
    """Cross-chunk combining funnel for banded_posteriors_many (the JAX
    package's `_FbFunnel`, banded.py:1309-1401).

    Chunk threads (and the score server's handlers for process workers)
    each call banded_posteriors_many against the one device. Concurrent
    calls with the same tables object, expansion, threshold, logAdd and
    `dynamic` merge: the thread that finds the device free becomes the
    dispatcher and runs a _PackRun over the union of the queued calls'
    items, absorbing newly queued calls between packs, and releases each
    caller once its own items are stored. A failure is raised on every
    waiter. Per-item results equal direct calls: a K2 or K3 block never
    reads across problems, and a pack's makeup changes only its padding."""

    def __init__(self):
        self._cond = threading.Condition()
        self._queue: list = []
        self._busy = False

    def solve(self, tables, items, expansion, threshold, use_lut, dynamic):
        if not items:
            return []
        req = _FbRequest((id(tables), expansion, threshold, use_lut,
                          dynamic), list(items))
        with self._cond:
            self._queue.append(req)
            while not req.done:
                if self._busy:
                    self._cond.wait()
                    continue
                self._busy = True
                self._cond.release()
                try:
                    self._dispatch(tables, req.key)
                finally:
                    self._cond.acquire()
                    self._busy = False
                    self._cond.notify_all()
        if req.error is not None:
            raise req.error
        return req.results

    def _complete(self, ref):
        with self._cond:
            ref.req.remaining -= 1
            if ref.req.remaining == 0:
                ref.req.done = True
                self._cond.notify_all()

    def _dispatch(self, tables, key):
        _, expansion, threshold, use_lut, dynamic = key
        seen: list = []

        def refill():
            with self._cond:
                mine = [r for r in self._queue if r.key == key]
                self._queue = [r for r in self._queue if r.key != key]
            seen.extend(mine)
            return [_ItemRef(it, r.results, i, r) for r in mine
                    for i, it in enumerate(r.items)]

        try:
            _PackRun(tables, expansion, threshold, use_lut, dynamic,
                     complete=self._complete).drain(refill)
        except BaseException as e:
            with self._cond:
                for r in seen:
                    if not r.done:
                        r.error = e
                        r.done = True
                self._cond.notify_all()
            raise


_FB_FUNNEL = _FbFunnel()


def _fb_funnel_enabled() -> bool:
    return os.environ.get("MARGIN_TPU_FB_FUNNEL", "1") != "0"


def _posteriors_direct(tables, items, expansion, threshold, use_lut,
                       dynamic):
    results = [None] * len(items)
    run = _PackRun(tables, expansion, threshold, use_lut, dynamic)
    run.add([_ItemRef(it, results, i) for i, it in enumerate(items)])
    run.drain()
    return results


def _worker_posteriors(tables, items, expansion, threshold, use_lut,
                       dynamic):
    """A process worker's call (banded.py:1656-1728): the items the parent
    would route to its host engine (bands wider than 128 cells, or deeper
    than MAX_DIAGONALS) solve on this worker's own engine, the rest go to
    the parent's device over the socket, shipped first so the parent works
    while this worker solves; so process mode routes every item as thread
    mode does."""
    from margin_tpu_torch.ops import native_fb
    from margin_tpu_torch.parallel import executor
    local = []
    if native_fb.lib() is not None:
        local = [i for i, it in enumerate(items)
                 if len(it["x_sym"]) + len(it["y_sym"]) > 0
                 and _route(_item_geom(it, expansion, dynamic)) == "host"]
    if not local:
        return executor.ipc_banded(tables, items, expansion, threshold,
                                   use_lut, dynamic)
    results = [None] * len(items)
    local_set = set(local)
    remote = [i for i in range(len(items)) if i not in local_set]
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(executor.ipc_banded, tables,
                          [items[i] for i in remote], expansion, threshold,
                          use_lut, dynamic) if remote else None
        try:
            for i, r in zip(local, _solve_native_items(
                    tables, [items[i] for i in local], expansion, threshold,
                    use_lut, dynamic)):
                results[i] = r
        except BaseException:
            if fut is not None:
                fut.exception()   # the shipped batch is waited for
            raise
        remote_res = fut.result() if fut is not None else []
    for i, r in zip(remote, remote_res):
        results[i] = r
    return results


def banded_posteriors_many(tables, items, expansion: int,
                           threshold: float = 0.01, use_lut: bool = False,
                           dynamic: bool = False):
    """Batched banded posteriors on the tables' device. `items` is a list
    of dicts with keys x_sym, y_sym, anchors, strand, and optional
    rep_x/rep_y, ragged_left/right. Returns a list of
    ((matches, gapx, gapy), total) in input order, each pair list int64
    (prob scaled by 1e7, x, y) rows sorted by (x, y). In a process worker
    (an IPC client installed) the batch goes to the parent's device; else
    through the cross-call funnel (MARGIN_TPU_FB_FUNNEL=0: a direct
    _PackRun)."""
    from margin_tpu_torch.parallel import executor
    if executor.has_ipc_client() and items:
        return _worker_posteriors(tables, items, expansion, threshold,
                                  use_lut, dynamic)
    if _fb_funnel_enabled():
        return _FB_FUNNEL.solve(tables, items, expansion, threshold,
                                use_lut, dynamic)
    return _posteriors_direct(tables, items, expansion, threshold, use_lut,
                              dynamic)


def _on_card(tables) -> bool:
    """Whether the tables (and so the packs) live on a CUDA device."""
    return tables.device.type == "cuda"


def _round8(w: int) -> int:
    """A wide band's storage width on the plain twins (the JAX package's
    w_pad rounding, banded.py:1928)."""
    return -(-w // 8) * 8


def _solve_pack(tables, items, geoms, w_pad, use_rle, expansion, use_lut,
                dynamic, threshold, refs):
    t0 = time.perf_counter()
    packed, pack = cuda_banded.fb_posteriors_words(
        tables, items, w_pad, expansion, use_lut, dynamic, use_rle,
        threshold, geoms_in=geoms, device=tables.device)
    packed = packed.cpu().numpy()
    _store_pack_results(refs, packed, pack, time.perf_counter() - t0)


def _solve_seg_pack(tables, items, geoms, w_pad, use_rle, expansion,
                    use_lut, dynamic, threshold, refs):
    t0 = time.perf_counter()
    packed, pack = cuda_banded.fb_posteriors_seg(
        tables, items, w_pad, expansion, use_lut, dynamic, use_rle,
        threshold, cuda_banded.SEG_D[w_pad], geoms_in=geoms,
        device=tables.device)
    packed = packed.cpu().numpy()
    _store_pack_results(refs, packed, pack, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# transition expectations (Baum-Welch)
# ---------------------------------------------------------------------------

# The ROADMAP's title of the wide-band forward-backward: its forward and
# expectation halves are kernels K5-fwd / K5-exp (csrc/banded_wide.cu);
# wide posteriors stay on the host engine, as margin_tpu routes them.
K5_ITEM = "ROADMAP queue 2, K5: the wide-band forward-backward"


def expectation_packs(tables, items, expansion: int, dynamic: bool = False):
    """The packs banded_expectations_many launches on, built one at a
    time: yields (item indices, BandPack). Items go by band width and RLE
    state into packs of at most 128 problems, deepest first, whose grids
    stay within cuda_banded.FB_GRID_BUDGET_BYTES: a band of at most 128
    cells at its width bucket (16, 32, 64, 128) for K2-fwd and K4,
    whatever its depth (the expectations need no segmented route); a wider
    band at its width rounded up to 8 (the JAX package's w_pad) for K5-fwd
    and K5-exp (a pack of W > 128). Empty items get none."""
    buckets: dict = {}        # (w_pad, use_rle) -> [(lx+ly, i)]
    for i, it in enumerate(items):
        lx, ly = len(it["x_sym"]), len(it["y_sym"])
        if lx + ly == 0:
            continue
        geom = _item_geom(it, expansion, dynamic)
        use_rle = it.get("rep_x") is not None and tables.repeat is not None
        w = _bucket_w(geom.w_pad) if geom.w_pad <= 128 else \
            _round8(geom.w_pad)
        if cuda_banded.grid_bytes(lx + ly + 1, w) \
                > cuda_banded.FB_GRID_BUDGET_BYTES:
            raise ValueError(
                f"a problem of {lx + ly + 1} diagonals: its forward grid "
                "exceeds cuda_banded.FB_GRID_BUDGET_BYTES")
        buckets.setdefault((w, use_rle), []).append((lx + ly, i))
    for (w, rle), entries in buckets.items():
        for idxs in _packs(entries, w, False):
            yield idxs, cuda_banded._pack_host(
                tables, [items[i] for i in idxs], w, expansion, dynamic, rle,
                [items[i]["_geom"] for i in idxs], device=tables.device)


def banded_expectations_many(tables, items, expansion: int,
                             use_lut: bool = False, dynamic: bool = False):
    """Transition expectations of many problems (items as in
    banded_posteriors_many): a list of (E (3, 3) float64 [from, to]
    expected transition counts, total log prob) in input order, from each
    of expectation_packs: K2-fwd and then K4 (fb_expectations) on a pack
    of W <= 128, K5-fwd and then K5-exp (fb_expectations_wide) on a wider
    one."""
    results = [(np.zeros((3, 3)), 0.0) for _ in items]
    for idxs, pack in expectation_packs(tables, items, expansion, dynamic):
        if pack.W > 128:
            fwd, totals = cuda_banded.fb_forward_wide(pack, use_lut)
            e = cuda_banded.fb_expectations_wide(pack, fwd, totals, use_lut)
        else:
            fwd, totals = cuda_banded.fb_forward(pack, use_lut)
            e = cuda_banded.fb_expectations(pack, fwd, totals, use_lut)
        e = e.cpu().numpy().astype(np.float64)
        totals = totals.cpu().numpy()
        for k, i in enumerate(idxs):
            results[i] = (e[k], float(totals[k]))
    return results


def banded_expectations(tables, x_sym, y_sym, anchors, expansion: int,
                        strand: int, ragged_left=False, ragged_right=False,
                        use_lut: bool = False, pad_shapes: bool = True):
    """getExpectationsUsingAnchors (pairwiseAligner.c:1193-1209): Baum-Welch
    transition expectations over the banded forward-backward of one
    problem. Returns (E (3, 3) float64 [from, to] expected transition
    counts, total log prob). pad_shapes is the JAX package's shape
    bucketing for its compiled scans; a CUDA block walks the problem's own
    depth, so it changes nothing here."""
    item = {"x_sym": np.asarray(x_sym), "y_sym": np.asarray(y_sym),
            "anchors": [] if anchors is None else anchors,
            "strand": int(strand), "ragged_left": bool(ragged_left),
            "ragged_right": bool(ragged_right)}
    return banded_expectations_many(tables, [item], expansion,
                                    use_lut=use_lut)[0]


# ---------------------------------------------------------------------------
# single items and large-gap splits
# ---------------------------------------------------------------------------

def get_split_points(anchors, lx: int, ly: int, split_bigger_than: int,
                     ragged_left: bool, ragged_right: bool):
    """getSplitPoints (pairwiseAligner.c:913-966): split the DP into
    sub-rectangles around anchor gaps whose area exceeds
    splitMatrixBiggerThanThis. Returns [(x1, y1, x2, y2)]."""
    import math
    out = []
    state = [0, 0]  # current region origin (x1, y1)

    def split_p(x2, y2, x3, y3, skip_block):
        lx2, ly2 = x3 - x2, y3 - y2
        if lx2 * ly2 > split_bigger_than:
            max_len = int(math.sqrt(split_bigger_than))
            hx = max_len if lx2 // 2 > max_len else lx2 // 2
            hy = max_len if ly2 // 2 > max_len else ly2 // 2
            if not skip_block:
                out.append((state[0], state[1], x2 + hx, y2 + hy))
            state[0] = x3 - hx
            state[1] = y3 - hy
            return True
        return False

    x2 = y2 = 0
    for i, a in enumerate(anchors):
        x3, y3 = int(a[0]), int(a[1])
        split_p(x2, y2, x3, y3, ragged_left and i == 0)
        x2, y2 = x3 + 1, y3 + 1
    if (not split_p(x2, y2, lx, ly, ragged_left and len(anchors) == 0)
            or not ragged_right):
        out.append((state[0], state[1], lx, ly))
    return out


def _sub_anchors(anchors, j: int, x1: int, y1: int, x2: int, y2: int):
    """Anchors from index j with x + y < x2 + y2, shifted to (x1, y1);
    returns (shifted anchors, next j)."""
    sub = []
    while j < len(anchors):
        x, y = anchors[j][0], anchors[j][1]
        if x + y >= x2 + y2:
            break
        sub.append((x - x1, y - y1) + tuple(anchors[j][2:]))
        j += 1
    return sub, j


def split_sub_items(item, split_bigger_than: int):
    """Segment one problem at large anchor gaps into ragged sub-items
    (getPosteriorProbsWithBandingSplittingAlignmentsByLargeGaps,
    pairwiseAligner.c:984-1040) so long-gap reads ride the batched solver
    with everything else. Returns (sub_items, (x1, y1) offsets)."""
    x_sym, y_sym = item["x_sym"], item["y_sym"]
    anchors = [] if item["anchors"] is None else \
        [tuple(int(v) for v in a) for a in item["anchors"]]
    splits = get_split_points(anchors, len(x_sym), len(y_sym),
                              split_bigger_than, False, False)
    subs, offs = [], []
    j = 0
    for i, (x1, y1, x2, y2) in enumerate(splits):
        sub_anchors, j = _sub_anchors(anchors, j, x1, y1, x2, y2)
        sub = {"x_sym": x_sym[x1:x2], "y_sym": y_sym[y1:y2],
               "anchors": sub_anchors, "strand": item["strand"],
               "ragged_left": i > 0, "ragged_right": i < len(splits) - 1}
        if item.get("rep_x") is not None:
            sub["rep_x"] = item["rep_x"][x1:x2]
            sub["rep_y"] = item["rep_y"][y1:y2]
        subs.append(sub)
        offs.append((x1, y1))
    return subs, offs


def banded_posteriors(tables, x_sym, y_sym, anchors, expansion: int,
                      strand: int, ragged_left=False, ragged_right=False,
                      threshold: float = 0.01, use_lut: bool = False,
                      dynamic: bool = False, rep_x=None, rep_y=None):
    """One problem (getAlignedPairsWithIndelsUsingAnchors,
    pairwiseAligner.c:1144-1171): ((matches, gapx, gapy), total), pair
    lists of (prob scaled by 1e7, x, y) >= threshold. gapX pairs are
    reference-consuming (deletes in the POA's frame); gapY are
    read-consuming (inserts). Routed like any item of
    banded_posteriors_many."""
    item = {"x_sym": np.asarray(x_sym), "y_sym": np.asarray(y_sym),
            "anchors": [] if anchors is None else anchors,
            "strand": int(strand), "ragged_left": bool(ragged_left),
            "ragged_right": bool(ragged_right)}
    if rep_x is not None:
        item["rep_x"], item["rep_y"] = rep_x, rep_y
    return banded_posteriors_many(tables, [item], expansion,
                                  threshold=threshold, use_lut=use_lut,
                                  dynamic=dynamic)[0]


def banded_posteriors_split(tables, x_sym, y_sym, anchors, expansion: int,
                            strand: int, split_bigger_than: int,
                            ragged_left=False, ragged_right=False,
                            threshold: float = 0.01, use_lut: bool = False,
                            dynamic: bool = False, rep_x=None, rep_y=None):
    """getPosteriorProbsWithBandingSplittingAlignmentsByLargeGaps
    (pairwiseAligner.c:984-1040): banded posteriors of each sub-rectangle
    between large anchor gaps (one banded_posteriors_many call for them
    all), the pair lists merged back into the problem's coordinates.
    Returns ((matches, gapx, gapy), summed total), as banded_posteriors."""
    lx, ly = len(x_sym), len(y_sym)
    anchors = [] if anchors is None else [tuple(int(v) for v in a)
                                          for a in anchors]
    splits = get_split_points(anchors, lx, ly, split_bigger_than,
                              bool(ragged_left), bool(ragged_right))
    subs, j = [], 0
    for i, (x1, y1, x2, y2) in enumerate(splits):
        sub_anchors, j = _sub_anchors(anchors, j, x1, y1, x2, y2)
        sub = {"x_sym": np.asarray(x_sym[x1:x2]),
               "y_sym": np.asarray(y_sym[y1:y2]), "anchors": sub_anchors,
               "strand": int(strand),
               "ragged_left": bool(ragged_left) or i > 0,
               "ragged_right": bool(ragged_right) or i < len(splits) - 1}
        if rep_x is not None:
            sub["rep_x"], sub["rep_y"] = rep_x[x1:x2], rep_y[y1:y2]
        subs.append(sub)
    results = banded_posteriors_many(tables, subs, expansion,
                                     threshold=threshold, use_lut=use_lut,
                                     dynamic=dynamic)
    out = ([], [], [])
    total = 0.0
    for (x1, y1, _, _), (pairs, t) in zip(splits, results):
        for arr, acc in zip(pairs, out):
            if len(arr):
                arr = arr.copy()
                arr[:, 1] += x1
                arr[:, 2] += y1
            acc.append(arr)
        total += t
    empty = np.zeros((0, 3), dtype=np.int64)
    return tuple(np.concatenate(a) if a else empty for a in out), total
