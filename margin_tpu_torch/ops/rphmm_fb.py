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
from margin_tpu_torch.params import MAX_READ_PARTITIONING_DEPTH

# big-but-safe int sentinels (margin_tpu/phase/rphmm_device.py:32-36): BIG
# masks invalid alleles out of min reductions (BIG + uint16 penalties stays
# far below 2**31); NEG masks padded cells out of max reductions
BIG = 1 << 28
NEG = -(1 << 30)

RPHMM_FB = _Counter()

# threads of an emissions block (a thread a cell) and, at most, of the
# chain's block
EMISSION_THREADS = 128
CHAIN_THREADS = 1024
# an allele's eight uint64 bit planes and its int32 total
PLANE_BYTES = 8 * 8 + 4
# where a site of more alleles than the register bucket keeps its sums,
# and where the chain keeps its merge rows (csrc/rphmm_fb.cu's codes)
_SUMS = {"registers": 0, "shared": 1, "device": 2}
_CARRY = {"shared": 0, "device": 1}


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
    lib.k6_rphmm_fb.argtypes = [_P] * 17 + [ctypes.c_int] * 19 + [_P]
    lib.k6_emission_bytes.restype = ctypes.c_int
    lib.k6_emission_bytes.argtypes = [ctypes.c_int] * 6
    lib.k6_chain_bytes.restype = ctypes.c_int
    lib.k6_chain_bytes.argtypes = [ctypes.c_int] * 2
    return lib


class K6Launch(NamedTuple):
    """K6's launch layout (csrc/rphmm_fb.cu mirrors its byte counts).
    Emissions: `threads` a block, `tiles` blocks a column; `nr` the
    register bucket (4 or 16 alleles) of a site's allele sums with the
    ancestor; `sums`, where a site of more alleles keeps them ("registers":
    no such site, "shared", or "device": a slice a block of a buffer the
    wrapper allocates); the planes of `cap_a` alleles and (`stage_sub`) the
    substitutions and priors of `cap_s` sites a chunk, in `emission_bytes`
    of shared memory. Chain: two blocks (the forward and the backward
    sweep) of `chain_threads` threads of `chain_cpt` cells each (0: inputs
    loaded where used, any C), the merge rows' `carry` in "shared" memory
    (three rows, `chain_bytes` a block) or in "device" memory."""
    threads: int
    tiles: int
    nr: int
    sums: str
    cap_a: int
    cap_s: int
    stage_sub: bool
    emission_bytes: int
    chain_cpt: int
    chain_threads: int
    carry: str
    chain_bytes: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def k6_launch(C: int, A: int, D: int, As: int, S: int, M: int,
              ancestor: bool) -> K6Launch:
    """The layout K6 launches a pack of these dimensions with, chosen by
    size before the launch. With the ancestor, a site's allele sums stay
    in registers up to 16 alleles (the bucket of 4 when no site has more);
    a wider site keeps 2 x As ints a thread in shared memory at the most
    threads of 128, 64, 32 that fit beside one site's planes (up to 717
    alleles), else in device memory. The planes (and staged sites) of a
    column fit in one chunk when they can, else in chunks of whole sites.
    The chain's three merge rows live in shared memory while 3 x M ints fit
    (M up to 19,370), else in device memory; a chain thread holds 1, 2 or 4
    cells, the fewest that fit 1024 threads, beyond 4096 cells any number.
    Raises ValueError for D over 64 reads."""
    if D > MAX_READ_PARTITIONING_DEPTH:
        raise ValueError(f"K6 takes at most {MAX_READ_PARTITIONING_DEPTH} "
                         f"reads a column (a partition's bits), not {D}")
    nr = 4 if As <= 4 else 16
    wide = ancestor and As > nr
    stage = ancestor and not wide
    site_bytes = (As * As + As) * 4 if stage else 0
    threads, sums = EMISSION_THREADS, "registers"
    if wide:
        sums = "device"
        for t in (128, 64, 32):
            if 2 * As * t * 4 + As * PLANE_BYTES <= _ext.MAX_SMEM:
                threads, sums = t, "shared"
                break
    sums_bytes = 2 * As * threads * 4 if sums == "shared" else 0
    room = _ext.MAX_SMEM - sums_bytes
    cap_a, cap_s = A, S
    if A * PLANE_BYTES + S * site_bytes > room:
        if stage:
            cap_s = max(1, min(S, room // 2 // site_bytes))
        cap_a = min(A, (room - cap_s * site_bytes) // PLANE_BYTES)
    if cap_a < As:
        raise ValueError(f"a site of {As} alleles does not fit K6's "
                         "shared memory")
    cpt = next((n for n in (1, 2, 4) if C <= n * CHAIN_THREADS), 0)
    chain_threads = (_ceil(_ceil(C, cpt), 32) * 32 if cpt
                     else CHAIN_THREADS)
    carry = "shared" if 3 * M * 4 <= _ext.MAX_SMEM else "device"
    return K6Launch(threads, _ceil(C, threads), nr, sums, cap_a, cap_s, stage,
                    cap_a * PLANE_BYTES + cap_s * site_bytes + sums_bytes,
                    cpt, chain_threads, carry,
                    3 * M * 4 if carry == "shared" else 0)


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
    lay = k6_launch(C, A, D, As, S, M, bool(include_ancestor))
    # a site's allele sums that fit nowhere else: a slice of 2 x As ints a
    # thread for each emissions block
    sums = (torch.empty(ncol * lay.tiles * 2 * As * lay.threads,
                        dtype=torch.int32, device=dev)
            if lay.sums == "device" else None)
    out = [torch.empty((ncol, C), dtype=torch.int32, device=dev)
           for _ in range(3)]
    out += [torch.empty((ncol, M), dtype=torch.int32, device=dev)
            for _ in range(2)]
    rc = _ext.launch(
        dev, _k6().k6_rphmm_fb, pk.parts.data_ptr(),
        pk.n_cells.data_ptr(), pk.depth.data_ptr(), pk.n_sites.data_ptr(), pk.pt.data_ptr(), pk.site_off.data_ptr(),
        pk.site_a.data_ptr(), pk.sub.data_ptr(), pk.prior.data_ptr(),
        pk.idx_prev.data_ptr(), pk.idx_next.data_ptr(),
        *(t.data_ptr() for t in out),
        None if sums is None else sums.data_ptr(),
        ncol, C, D, A, S, As, M, int(include_ancestor), lay.threads,
        lay.cap_a, lay.cap_s, int(lay.stage_sub), _SUMS[lay.sums], lay.nr,
        lay.emission_bytes, lay.chain_cpt, lay.chain_threads,
        _CARRY[lay.carry], lay.chain_bytes)
    _ext.check_launch(rc, "read-partition HMM forward-backward (K6)")
    RPHMM_FB.add()
    return tuple(out)


def matmul_sums(parts: torch.Tensor, pt: torch.Tensor):
    """The twin's emission sums of one column: (s1, s2), (C, A) int32, the
    sums of each allele's profile bytes over the reads in each cell's
    partition (s1) and over the rest (s2), as a matmul of the read bits
    (parts (C,) int64) with the bytes (pt (A, D) uint8) in float64 (exact:
    every partial sum is an integer below 2**24), then int32 as in
    `_fb_jit`."""
    shifts = torch.arange(pt.shape[1], device=parts.device)
    bits = ((parts[:, None] >> shifts[None, :]) & 1).double()
    p = pt.T.double()                                          # (D, A)
    return (bits @ p).to(torch.int32), ((1.0 - bits) @ p).to(torch.int32)


def bitplane_sums(parts: torch.Tensor, pt: torch.Tensor):
    """`matmul_sums` as K6 forms them, in plain PyTorch, for the checks:
    allele a's eight planes (bit r of plane b = bit b of pt[a, r]) and its
    total over the reads; s1 = sum_b popcount(bits & plane[a, b]) << b,
    s2 = total[a] - s1. D <= 64."""
    D = pt.shape[1]
    dev = parts.device
    b = torch.arange(8, device=dev)
    r = torch.arange(D, device=dev)
    p = pt.long()
    planes = (((p[:, None, :] >> b[None, :, None]) & 1)
              << r[None, None, :]).sum(dim=2)                  # (A, 8)
    anded = parts[:, None, None] & planes[None]                # (C, A, 8)
    pop = ((anded[..., None] >> torch.arange(64, device=dev)) & 1).sum(-1)
    s1 = (pop << b).sum(dim=2)
    return s1.to(torch.int32), (p.sum(dim=1)[None] - s1).to(torch.int32)


def rphmm_fb_plain(pk: RphmmPack, include_ancestor: bool):
    """Plain PyTorch twin of K6: `_fb_jit`'s int32 arithmetic column by
    column, the emission sums by `matmul_sums`."""
    ncol, C, D, A, S, As, M = pk.dims
    dev = pk.parts.device
    i32 = torch.int32
    big = torch.tensor(BIG, dtype=i32, device=dev)
    neg_row = torch.full((M,), NEG, dtype=i32, device=dev)
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
        s1, s2 = matmul_sums(pk.parts[ci], pk.pt[ci])          # (C, A)
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
