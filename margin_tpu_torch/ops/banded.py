"""Batched banded pair-HMM forward-backward with posterior extraction.

Counterpart of the part of `margin_tpu/ops/banded.py` that `margin phase`
reaches: `BandGeometry` (:40-125), `_bucket_w` (:126), `_true_band_cells`
(:1465), `_item_geom` (:1473), the flat posterior extraction
(`_device_extract_flat` / `_unpack_extract` / `_store_pack_results`,
:704-773 and :974-1000) and `banded_posteriors_many` (:1637-1798).
Parity: getPosteriorProbsWithBanding (pairwiseAligner.c:706-844).

Band geometry: cell k of diagonal d is xmy = xmyL[d] + 2k, with
x = (d+xmy)/2, y = (d-xmy)/2.

Routing, as the JAX package routes on an accelerator
(banded.py:1140-1183): an item whose smoothed band is at most 128 cells
wide goes to the pack kernels (ops/cuda_banded.py, K2); a wider one goes
to the host C++ engine (native/marginfb.cc). Three TPU workarounds are
not carried over: the launch-latency threshold `_device_min_cells`, the
6144-diagonal floor and the diagonal bucketing `_bucket_dpad` — a CUDA
block walks each problem's own depth. The worker-process branch and the
cross-chunk funnel `_FbFunnel` wait for a later slice; results do not
depend on them.
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

    def add(self, pack_items=0, host_items=0, packs=0):
        with self._lock:
            self.pack_items += pack_items
            self.host_items += host_items
            self.packs += packs

    def reset(self):
        with self._lock:
            self.pack_items = self.host_items = self.packs = 0


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
    threaded (each call releases the GIL)."""
    from margin_tpu_torch.ops import native_fb

    def one(i):
        return native_fb.posteriors_item(tables, items[i], expansion,
                                         threshold, use_lut, dynamic)

    n_threads = max(1, min(os.cpu_count() or 1, len(items)))
    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        return list(ex.map(one, range(len(items))))


def _packs(entries, w_pad: int):
    """Cut (lx+ly, item index) entries of one width bucket into packs of at most
    PACK_MAX_B problems whose grids fit the memory budget, deepest first
    so problems of like depth share a pack."""
    entries = sorted(entries, key=lambda e: -e[0])
    pack, rows = [], 0
    for d, ref in entries:
        need = d + 1
        if cuda_banded.grid_bytes(need, w_pad) > \
                cuda_banded.FB_GRID_BUDGET_BYTES:
            raise NotImplementedError(
                f"a banded problem of {need} diagonals at width {w_pad} "
                "exceeds the pack memory budget; it needs the segmented "
                "kernels K3 (ROADMAP queue 1, slice 2)")
        if pack and (len(pack) == PACK_MAX_B or cuda_banded.grid_bytes(
                rows + need, w_pad) > cuda_banded.FB_GRID_BUDGET_BYTES):
            yield pack
            pack, rows = [], 0
        pack.append(ref)
        rows += need
    if pack:
        yield pack


def banded_posteriors_many(tables, items, expansion: int,
                           threshold: float = 0.01, use_lut: bool = False,
                           dynamic: bool = False):
    """Batched banded posteriors on the tables' device. `items` is a list
    of dicts with keys x_sym, y_sym, anchors, strand, and optional
    rep_x/rep_y, ragged_left/right. Returns a list of
    ((matches, gapx, gapy), total) in input order, each pair list int64
    (prob scaled by 1e7, x, y) rows sorted by (x, y)."""
    from margin_tpu_torch.ops import native_fb

    results = [None] * len(items)
    buckets: dict = {}        # (w_pad, use_rle) -> [(lx+ly, (results, i))]
    host_idx = []
    for i, it in enumerate(items):
        lx, ly = len(it["x_sym"]), len(it["y_sym"])
        if lx + ly == 0:
            empty = np.zeros((0, 3), dtype=np.int64)
            results[i] = ((empty, empty, empty), 0.0)
            continue
        geom = _item_geom(it, expansion, dynamic)
        if geom.w_pad > 128:
            host_idx.append(i)
            continue
        use_rle = it.get("rep_x") is not None and tables.repeat is not None
        buckets.setdefault((_bucket_w(geom.w_pad), use_rle), []).append(
            (lx + ly, i))

    # wide bands run on the host engine while the device solves the packs
    pool = fut = None
    wide_on_host = bool(host_idx) and native_fb.lib() is not None
    if wide_on_host:
        pool = ThreadPoolExecutor(max_workers=1)
        fut = pool.submit(_solve_native_items, tables,
                          [items[i] for i in host_idx], expansion,
                          threshold, use_lut, dynamic)
    elif host_idx:
        # no host engine: the plain twins take the wide bands on the CPU,
        # as the JAX package's pure-XLA scan does
        for i in host_idx:
            geom = _item_geom(items[i], expansion, dynamic)
            w = int(np.ceil(geom.w_pad / 8)) * 8
            use_rle = (items[i].get("rep_x") is not None
                       and tables.repeat is not None)
            _solve_pack(_on_cpu(tables), [items[i]], [geom], w, use_rle,
                        expansion, use_lut, dynamic, threshold,
                        [(results, i)])
    try:
        for (w_pad, use_rle), entries in buckets.items():
            for idxs in _packs(entries, w_pad):
                _solve_pack(tables, [items[i] for i in idxs],
                            [items[i]["_geom"] for i in idxs], w_pad,
                            use_rle, expansion, use_lut, dynamic, threshold,
                            [(results, i) for i in idxs])
                ROUTES.add(pack_items=len(idxs), packs=1)
    finally:
        if fut is not None:
            host_res = fut.result()
            pool.shutdown()
            for i, r in zip(host_idx, host_res):
                results[i] = r
            ROUTES.add(host_items=len(host_idx))
    return results


def _on_cpu(tables):
    from margin_tpu_torch.ops import pairhmm
    h = tables.host
    return pairhmm.tables_from_numpy(h["match"], h["gap_x"], h["gap_y"],
                                     h["trans"], h["repeat"], device="cpu")


def _solve_pack(tables, items, geoms, w_pad, use_rle, expansion, use_lut,
                dynamic, threshold, refs):
    post, totals, pack = cuda_banded.fb_posteriors_group(
        tables, items, w_pad, expansion, use_lut, dynamic, use_rle,
        geoms_in=geoms, device=tables.device)
    t0 = time.perf_counter()
    packed = extract_packed(post, totals, pack, threshold).cpu().numpy()
    _store_pack_results(refs, packed, pack, time.perf_counter() - t0)
