"""Device forward-backward of the read-partition HMM (stRPHmm).

Counterpart of `margin_tpu/phase/rphmm_device.py`. With the default
``maxNotSumTransitions=true`` every quantity of the FB is an integer
(uint8 profile probabilities, uint16 penalties, + and max), so the int32
device computation is bit-identical to the float64 host implementation in
`phase.rphmm`, which stays the oracle; the logaddexp path
(maxNotSumTransitions=false) stays on the host.

`forward_backward_device` packs one HMM on the host (the padded layout of
`margin_tpu/phase/rphmm_device.py:165-229`, padded to the HMM's own
maxima: K6 needs no power-of-two buckets), runs `ops.rphmm_fb.rphmm_fb`
(kernel K6 on a CUDA device, its plain twin on the CPU), reads the results
back once and fills the fields the host path fills.

Dispatch policy (`use_device_fb`), as in margin_tpu with the device the
HMM was built for in place of the JAX backend: HMMs above a work threshold
run on a CUDA device; tiny ones (the vast majority) stay on the host,
where the device round trip would dominate. ``MARGIN_TPU_RPHMM=device|host``
overrides; ``MARGIN_TPU_RPHMM_THRESHOLD`` sets the threshold.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from margin_tpu_torch.ops.rphmm_fb import BIG, RphmmPack, rphmm_fb

# conservative per-site emission magnitude bound: 2*(maxDepth*255 + 65535)
# + 65535; chains whose total site count could overflow int32 forward sums
# stay on the host float64 path
_PER_SITE_BOUND = 2 * (64 * 255 + 65535) + 65535


def work(hmm) -> int:
    """The policy's work estimate: cells x reads summed over the columns."""
    return sum(len(c.partitions) * max(1, c.depth) for c in hmm.columns)


def use_device_fb(hmm, include_ancestor: bool, device) -> bool:
    """Whether `hmm`'s FB runs on `device` (margin_tpu's policy,
    rphmm_device.py:51-76): never for the logaddexp path or a chain that
    could overflow int32; always under MARGIN_TPU_RPHMM=device; under
    "auto" only on a CUDA device and for work (cells x reads summed over
    the columns) of at least MARGIN_TPU_RPHMM_THRESHOLD (10,000,000)."""
    mode = os.environ.get("MARGIN_TPU_RPHMM", "auto")
    if mode == "host":
        return False
    if not hmm.params.maxNotSumTransitions:
        return False  # logaddexp path: host float64 only
    total_sites = sum(c.length for c in hmm.columns)
    if total_sites * _PER_SITE_BOUND > (1 << 30):
        return False  # int32 forward-sum headroom
    if mode == "device":
        return True
    if torch.device(device).type != "cuda":
        return False
    # margin_tpu's threshold, kept so both packages choose alike; on an
    # H100 K6 with its pack and read-back overtakes the host FB far below
    # it (PERF.md, section 5)
    thresh = int(os.environ.get("MARGIN_TPU_RPHMM_THRESHOLD", 10_000_000))
    return work(hmm) >= thresh


# uint64 order as int64 order: flip bit 63
_FLIP = np.int64(-(1 << 63))
_TOP = np.iinfo(np.int64).max   # the sentinel past every key
_TORCH = {np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
          np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64}


def _merge_maps(merges, keys, order, masks):
    """Fill the merge index maps' search tables, side 0 for idx_prev (the
    merge before each column, its to-side; none before column 0), side 1
    for idx_next (the merge after it, its from-side; none after the last):
    each merge's sorted keys (MergeColumn.sorted_keys, bit 63 flipped)
    padded to M with _TOP, keys (2, ncol, M) int64; their indices padded
    with 0, order (2, ncol, M) int32; its mask, masks (2, ncol, 1) int64. A
    column with no merge on a side has a row of _TOP keys and 0 indices, so
    it finds index 0."""
    keys[...] = _TOP
    order[...] = 0
    for side, first, name in ((0, 1, "to"), (1, 0, "from")):
        for ci, m in enumerate(merges, first):
            k, o = m.sorted_keys(name)
            np.bitwise_xor(k.view(np.int64), _FLIP,
                           out=keys[side, ci, :len(k)])
            order[side, ci, :len(k)] = o
    bits = masks.view(np.uint64)
    bits[...] = 0
    bits[0, 1:, 0] = [m.mask_to for m in merges]
    bits[1, :-1, 0] = [m.mask_from for m in merges]


class _Staging:
    """One host buffer holding an array of each (shape, dtype) of `specs`,
    each at an offset that is a multiple of 8: `arrays` are views of it,
    to be filled in place, then moved to a device by one copy."""

    def __init__(self, specs):
        self.specs = [(tuple(shape), np.dtype(dt)) for shape, dt in specs]
        self.offs, n = [], 0
        for shape, dt in self.specs:
            self.offs.append(n)
            n += -(-math.prod(shape) * dt.itemsize // 8) * 8
        self.buf = np.empty(n, dtype=np.uint8)
        self.arrays = [np.ndarray(shape, dt, self.buf, o)
                       for (shape, dt), o in zip(self.specs, self.offs)]

    def to(self, device):
        """The arrays on `device`, views of one copy of the buffer."""
        flat = torch.from_numpy(self.buf).to(device)
        typed = {dt: flat.view(_TORCH[dt]) for dt in {d for _, d in
                                                      self.specs}}
        out = []
        for (shape, dt), o in zip(self.specs, self.offs):
            strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
            out.append(typed[dt].as_strided(shape, strides,
                                            o // dt.itemsize))
        return out


def pack(hmm, device) -> RphmmPack:
    """One HMM's FB inputs (ops.rphmm_fb.RphmmPack) on `device`, the
    padded layout of margin_tpu's slabs, built from whole arrays: the
    columns' uint64 partitions (Column.parts_u64), the profile bytes by one
    gather over the reads' concatenated probabilities, the sites' arrays
    by one gather from per-site arrays, staged on the host in one buffer
    and moved by one copy; the merge index maps by one batched
    searchsorted on `device` in the merges' sorted keys
    (MergeColumn.sorted_keys), none where the HMM has one column."""
    cols = hmm.columns
    merges = hmm.merges
    ncol = len(cols)
    offsets = hmm.ref.allele_offsets()
    n_cells = np.array([len(c.partitions) for c in cols], dtype=np.int32)
    depth = np.array([c.depth for c in cols], dtype=np.int32)
    n_sites = np.array([c.length for c in cols], dtype=np.int32)
    start = np.array([c.ref_start for c in cols], dtype=np.int64)
    a0 = offsets[start]
    a_col = offsets[start + n_sites] - a0
    C = int(n_cells.max())
    D = -(-max(1, int(depth.max())) // 4) * 4
    A = max(1, int(a_col.max()))
    S = max(1, int(n_sites.max()))
    M = max([m.size() for m in merges] + [1])

    # the sites: per-site arrays over the HMM's reference range, gathered
    # by (column, site)
    lo = int(start.min())
    ref_sites = hmm.ref.sites[lo:int((start + n_sites).max())]
    na_all = np.array([s.allele_number for s in ref_sites], dtype=np.int32)
    width = max(2, int(na_all.max()))
    sub_all = np.full((len(ref_sites), width, width), BIG, dtype=np.int32)
    prior_all = np.zeros((len(ref_sites), width), dtype=np.int32)
    for i, s in enumerate(ref_sites):
        sub_all[i, :s.allele_number, :s.allele_number] = \
            s.substitution_log_probs
        prior_all[i, :s.allele_number] = s.allele_prior_log_probs
    j = np.arange(S)
    live = j[None, :] < n_sites[:, None]
    sidx = np.where(live, start[:, None] + j[None, :] - lo, 0)
    site_a = np.where(live, na_all[sidx], 0).astype(np.int32)
    As = max(2, int(site_a.max()))
    site_off = np.where(live, offsets[sidx + lo] - a0[:, None],
                        0).astype(np.int32)
    sub = np.where(live[:, :, None, None], sub_all[:, :As, :As][sidx],
                   BIG).astype(np.int32)
    prior = np.where(live[:, :, None], prior_all[:, :As][sidx],
                     0).astype(np.int32)

    # the profile bytes: pt[ci, a, r] = the probability of the column's
    # allele a in its read r, gathered from the reads' concatenation
    # (each read once, and each column's reads as indices into them)
    reads = [ps for col in cols for ps in col.seqs]
    index = {}
    read_seq = [index.setdefault(id(ps), len(index)) for ps in reads]
    seqs = list({id(ps): ps for ps in reads}.values())
    pt = np.zeros((ncol, A, D), dtype=np.uint8)
    if seqs:
        flat = np.concatenate([ps.probs for ps in seqs]).astype(np.uint8)
        lens = np.array([len(ps.probs) for ps in seqs], dtype=np.int64)
        base = np.cumsum(lens) - lens - np.array(
            [ps.allele_offset for ps in seqs], dtype=np.int64)
        read_col = np.repeat(np.arange(ncol), depth)
        first = np.full((ncol, D), -1, dtype=np.int64)    # (ncol, D)
        first[np.arange(D)[None, :] < depth[:, None]] = (
            base[np.array(read_seq, dtype=np.int64)] + a0[read_col])
        a = np.arange(A)[None, :, None]
        ok = (first[:, None, :] >= 0) & (a < a_col[:, None, None])
        pt = np.where(ok, flat[np.where(ok, first[:, None, :] + a, 0)], 0
                      ).astype(np.uint8)

    # every array staged in one host buffer, moved by one copy: the
    # partitions padded with 0 and the merge tables filled in place
    small = [n_cells, depth, n_sites, pt, site_off, site_a, sub, prior]
    specs = [((ncol, C), np.int64)] + [(a.shape, a.dtype) for a in small]
    specs += ([((2, ncol, M), np.int64), ((2, ncol, M), np.int32),
               ((2, ncol, 1), np.int64), ((ncol, C), np.bool_)] if merges
              else [((2, ncol, C), np.int32)])
    staged = _Staging(specs)
    host = staged.arrays
    parts = host[0]
    parts[...] = 0
    for ci, col in enumerate(cols):
        parts[ci, :n_cells[ci]] = col.parts_u64().view(np.int64)
    for a, h in zip(small, host[1:9]):
        h[...] = a
    if not merges:
        host[9][...] = 0
        dev = staged.to(torch.device(device))
        return RphmmPack(*dev[:9], dev[9][0], dev[9][1], M)
    _merge_maps(merges, *host[9:12])
    np.less(np.arange(C)[None, :], n_cells[:, None], out=host[12])
    dev = staged.to(torch.device(device))
    # each live cell's index among its merges' cells, idx_prev (side 0)
    # and idx_next (side 1): one batched searchsorted of the masked
    # partitions in the sorted keys; 0 for a padded cell
    keys, order, masks, live = dev[9:]
    needles = (dev[0] & masks) ^ int(_FLIP)                  # (2, ncol, C)
    pos = torch.searchsorted(keys.view(2 * ncol, M),
                             needles.view(2 * ncol, C))
    found = order.view(2 * ncol, M).gather(1, pos.clamp_(max=M - 1))
    idx = torch.where(live, found.view(2, ncol, C), 0)
    return RphmmPack(*dev[:9], idx[0], idx[1], M)


def fill(hmm, em, fwd, bwd, m_fwd, m_bwd) -> None:
    """Write the FB's int32 results (host numpy arrays) into the fields the
    host path fills (margin_tpu/phase/rphmm_device.py:245-259)."""
    cols = hmm.columns
    merges = hmm.merges
    ncol = len(cols)
    for ci, col in enumerate(cols):
        n = len(col.partitions)
        col.emission = em[ci, :n].astype(np.float64)
        col.forward = fwd[ci, :n].astype(np.float64)
        col.backward = bwd[ci, :n].astype(np.float64)
        col.total_log_prob = float(np.max(col.forward + col.backward))
        if ci < len(merges):
            m = merges[ci].size()
            merges[ci].forward = m_fwd[ci, :m].astype(np.float64)
            merges[ci].backward = m_bwd[ci + 1, :m].astype(np.float64)
    hmm.forward_log_prob = float(np.max(fwd[ncol - 1,
                                            :len(cols[-1].partitions)]))
    n0 = len(cols[0].partitions)
    hmm.backward_log_prob = float(np.max(em[0, :n0] + bwd[0, :n0]))


def forward_backward_device(hmm, include_ancestor: bool = True,
                            device="cuda") -> None:
    """Device FB for one RPHmm on `device` (K6 on a CUDA device, its plain
    twin on the CPU); fills the same fields the host path does
    (col.emission/forward/backward/total_log_prob, merge.forward/backward,
    hmm.forward_log_prob/backward_log_prob) with bit-identical values."""
    pk = pack(hmm, device)
    outs = rphmm_fb(pk, include_ancestor)
    flat = torch.cat([o.reshape(-1) for o in outs]).cpu().numpy()
    arrays, i = [], 0
    for o in outs:
        arrays.append(flat[i:i + o.numel()].reshape(o.shape))
        i += o.numel()
    fill(hmm, *arrays)
