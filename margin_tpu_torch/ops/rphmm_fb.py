"""Kernel K6: the read-partition HMM's int32 max-plus forward-backward.

`rphmm_fb` takes one HMM packed by `phase/rphmm_device.py:pack` and
returns its emissions, forward and backward values (ncol, C) and merge
vectors (ncol, M), all int32. A pack on a CUDA device launches K6
(`csrc/rphmm_fb.cu`) on the current stream; a pack on the CPU runs
`rphmm_fb_plain`, the plain PyTorch twin of
`margin_tpu/phase/rphmm_device.py:_fb_jit` (:80-156) with its int32
arithmetic on the same padded layout. Every value is an integer, so the
two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from margin_tpu_torch import _ext
from margin_tpu_torch.ops.pairhmm import _Counter, _check

# big-but-safe int sentinels (margin_tpu/phase/rphmm_device.py:32-36): BIG
# masks invalid alleles out of min reductions (BIG + uint16 penalties stays
# far below 2**31); NEG masks padded cells out of max reductions
BIG = 1 << 28
NEG = -(1 << 30)

RPHMM_FB = _Counter()

# threads of an emissions block (a thread a cell, strided)
EMISSION_THREADS = 128


@dataclass
class RphmmPack:
    """One HMM's FB inputs on one device (shapes in csrc/rphmm_fb.cu):
    parts (ncol, C) int64 partitions (bit d: read d in haplotype 1), padded
    with 0; n_cells, depth, n_sites (ncol,) int32; pt (ncol, A, D) uint8
    profile probabilities of the column's alleles by read, D a multiple of
    4; site_off, site_a (ncol, S) int32 each site's first allele in the
    column and allele count; sub (ncol, S, As, As) int32 substitution
    penalties, BIG where no allele; prior (ncol, S, As) int32;
    idx_prev / idx_next (ncol, C) int32 each cell's merge cell before /
    after (0 where there is none); M the widest merge column."""
    parts: torch.Tensor
    n_cells: torch.Tensor
    depth: torch.Tensor
    n_sites: torch.Tensor
    pt: torch.Tensor
    site_off: torch.Tensor
    site_a: torch.Tensor
    sub: torch.Tensor
    prior: torch.Tensor
    idx_prev: torch.Tensor
    idx_next: torch.Tensor
    M: int

    @property
    def dims(self):
        ncol, C = self.parts.shape
        _, A, D = self.pt.shape
        _, S, As, _ = self.sub.shape
        return ncol, C, D, A, S, As, self.M


_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _k6():
    lib = _ext.kernel_lib("rphmm_fb")
    lib.k6_rphmm_fb.restype = ctypes.c_int
    lib.k6_rphmm_fb.argtypes = [_P] * 17 + [ctypes.c_int] * 13 + [_P]
    return lib


class EmissionLayout(NamedTuple):
    """Where an emissions block keeps its data (csrc/rphmm_fb.cu:
    emission_smem): `bytes` of shared memory; `staged`, whether the
    column's A x D profile bytes are in it (else K6 reads them from device
    memory); `sums_shared`, whether a site's allele sums, 2 x As ints a
    thread with the ancestor, are in it (else in a device-memory slice a
    block that the wrapper allocates)."""
    bytes: int
    staged: bool
    sums_shared: bool


def emission_smem(A: int, D: int, As: int, ancestor: bool) -> EmissionLayout:
    """The layout of an emissions block. The ancestor's allele sums go to
    shared memory when they fit (a site of up to 227 alleles), else to
    device memory; the profile bytes are staged before the shared sums
    when both fit (up to ~3600 alleles at 64 reads)."""
    scratch = 2 * As * EMISSION_THREADS * 4 if ancestor else 0
    sums_shared = scratch <= _ext.MAX_SMEM
    shared = scratch if sums_shared else 0
    staged = A * D + shared <= _ext.MAX_SMEM
    return EmissionLayout((A * D if staged else 0) + shared, staged,
                          sums_shared)


def rphmm_fb(pk: RphmmPack, include_ancestor: bool):
    """(em, fwd, bwd, m_fwd, m_bwd) of one packed HMM: kernel K6 on a CUDA
    device, `rphmm_fb_plain` on the CPU."""
    dev = pk.parts.device
    if dev.type != "cuda":
        return rphmm_fb_plain(pk, include_ancestor)
    ncol, C, D, A, S, As, M = pk.dims
    _check(pk.parts, "parts", torch.int64, (ncol, C), dev)
    for name in ("n_cells", "depth", "n_sites"):
        _check(getattr(pk, name), name, torch.int32, (ncol,), dev)
    _check(pk.pt, "pt", torch.uint8, (ncol, A, D), dev)
    for name in ("site_off", "site_a"):
        _check(getattr(pk, name), name, torch.int32, (ncol, S), dev)
    _check(pk.sub, "sub", torch.int32, (ncol, S, As, As), dev)
    _check(pk.prior, "prior", torch.int32, (ncol, S, As), dev)
    for name in ("idx_prev", "idx_next"):
        _check(getattr(pk, name), name, torch.int32, (ncol, C), dev)
    lay = emission_smem(A, D, As, include_ancestor)
    # the ancestor's allele sums when they do not fit in shared memory: a
    # slice of 2 x As ints a thread for each column's block
    sums = (None if lay.sums_shared or not include_ancestor else
            torch.empty(ncol * 2 * As * EMISSION_THREADS, dtype=torch.int32,
                        device=dev))
    out = [torch.empty((ncol, C), dtype=torch.int32, device=dev)
           for _ in range(3)]
    out += [torch.empty((ncol, M), dtype=torch.int32, device=dev)
            for _ in range(2)]
    chain_threads = min(1024, -(-C // 32) * 32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _k6().k6_rphmm_fb(
        pk.parts.data_ptr(), pk.n_cells.data_ptr(), pk.depth.data_ptr(),
        pk.n_sites.data_ptr(), pk.pt.data_ptr(), pk.site_off.data_ptr(),
        pk.site_a.data_ptr(), pk.sub.data_ptr(), pk.prior.data_ptr(),
        pk.idx_prev.data_ptr(), pk.idx_next.data_ptr(),
        *(t.data_ptr() for t in out),
        None if sums is None else sums.data_ptr(),
        ncol, C, D, A, S, As, M, int(bool(include_ancestor)),
        EMISSION_THREADS, lay.bytes, int(lay.staged), int(lay.sums_shared),
        chain_threads, stream)
    _ext.check_launch(rc, "read-partition HMM forward-backward (K6)")
    RPHMM_FB.launches += 1
    return tuple(out)


def rphmm_fb_plain(pk: RphmmPack, include_ancestor: bool):
    """Plain PyTorch twin of K6: `_fb_jit`'s int32 arithmetic column by
    column. The emission sums are a matmul of the read bits with the
    profile bytes in float64 (exact: every partial sum is an integer below
    2**24), then int32 as in `_fb_jit`."""
    ncol, C, D, A, S, As, M = pk.dims
    dev = pk.parts.device
    i32 = torch.int32
    big = torch.tensor(BIG, dtype=i32, device=dev)
    neg_row = torch.full((M,), NEG, dtype=i32, device=dev)
    shifts = torch.arange(D, device=dev)
    j = torch.arange(As, device=dev)
    sites = torch.arange(S, device=dev)
    cells = torch.arange(C, device=dev)
    em = torch.empty((ncol, C), dtype=i32, device=dev)
    fwd = torch.empty_like(em)
    bwd = torch.empty_like(em)
    m_fwd = torch.empty((ncol, M), dtype=i32, device=dev)
    m_bwd = torch.empty_like(m_fwd)
    depth = pk.depth.tolist()
    n_sites = pk.n_sites.tolist()
    n_cells = pk.n_cells.tolist()
    for ci in range(ncol):
        bits = ((pk.parts[ci][:, None] >> shifts[None, :]) & 1).double()
        p = pk.pt[ci].T.double()                               # (D, A)
        s1 = (bits @ p).to(i32)                                # (C, A)
        s2 = ((1.0 - bits) @ p).to(i32)
        idx = (pk.site_off[ci][:, None] + j[None, :]).clamp(0, A - 1)
        valid_j = j[None, :] < pk.site_a[ci][:, None]          # (S, As)
        h1 = torch.where(valid_j[None], s1[:, idx.reshape(-1)]
                         .reshape(C, S, As), big)
        h2 = torch.where(valid_j[None], s2[:, idx.reshape(-1)]
                         .reshape(C, S, As), big)
        if include_ancestor:
            sub = pk.sub[ci]
            anc1 = torch.full((C, S, As), BIG, dtype=i32, device=dev)
            anc2 = torch.full((C, S, As), BIG, dtype=i32, device=dev)
            for k in range(As):
                anc1 = torch.minimum(anc1, h1[:, :, k:k + 1]
                                     + sub[None, :, :, k])
                anc2 = torch.minimum(anc2, h2[:, :, k:k + 1]
                                     + sub[None, :, :, k])
            tot_a = anc1 + anc2 + torch.where(valid_j, pk.prior[ci],
                                              big)[None]
            site_tot = tot_a.min(dim=2).values                 # (C, S)
        else:
            site_tot = h1.min(dim=2).values + h2.min(dim=2).values
        smask = sites < n_sites[ci]
        site_tot = torch.where(smask[None], site_tot, 0)
        e = -site_tot.sum(dim=1, dtype=i32)
        if depth[ci] == 0 or n_sites[ci] == 0:
            e = torch.zeros_like(e)
        em[ci] = e
    # forward chain (scatter-max into the merge slots by idx_next)
    carry = neg_row
    for ci in range(ncol):
        mask = cells < n_cells[ci]
        prev = (torch.zeros(C, dtype=i32, device=dev) if ci == 0
                else carry[pk.idx_prev[ci].long()])
        f = torch.where(mask, prev + em[ci], NEG)
        fwd[ci] = f
        carry = neg_row.scatter_reduce(0, pk.idx_next[ci].long(), f, "amax")
        m_fwd[ci] = carry
    # backward chain (scatter-max by idx_prev)
    carry = neg_row
    for ci in range(ncol - 1, -1, -1):
        mask = cells < n_cells[ci]
        b = (torch.zeros(C, dtype=i32, device=dev) if ci == ncol - 1
             else carry[pk.idx_next[ci].long()])
        b = torch.where(mask, b, NEG)
        bwd[ci] = b
        prop = torch.where(mask, em[ci] + b, NEG)
        carry = neg_row.scatter_reduce(0, pk.idx_prev[ci].long(), prop,
                                       "amax")
        m_bwd[ci] = carry
    return em, fwd, bwd, m_fwd, m_bwd
