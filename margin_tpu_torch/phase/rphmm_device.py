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


def pack(hmm, device) -> RphmmPack:
    """One HMM's FB inputs (ops.rphmm_fb.RphmmPack) on `device`, built on
    the host as margin_tpu builds its slabs, then moved in one copy each."""
    cols = hmm.columns
    merges = hmm.merges
    ncol = len(cols)
    offsets = hmm.ref.allele_offsets()
    sites = hmm.ref.sites
    C = max(len(c.partitions) for c in cols)
    D = -(-max(1, max(c.depth for c in cols)) // 4) * 4
    a_list = [int(offsets[c.ref_start + c.length] - offsets[c.ref_start])
              for c in cols]
    A = max(1, max(a_list))
    S = max(1, max(c.length for c in cols))
    As = max([sites[s].allele_number for c in cols
              for s in range(c.ref_start, c.ref_start + c.length)] + [2])
    M = max([m.size() for m in merges] + [1])

    parts = np.zeros((ncol, C), dtype=np.int64)
    n_cells = np.zeros(ncol, dtype=np.int32)
    depth = np.zeros(ncol, dtype=np.int32)
    n_sites = np.zeros(ncol, dtype=np.int32)
    pt = np.zeros((ncol, A, D), dtype=np.uint8)
    site_off = np.zeros((ncol, S), dtype=np.int32)
    site_a = np.zeros((ncol, S), dtype=np.int32)
    sub = np.full((ncol, S, As, As), BIG, dtype=np.int32)
    prior = np.zeros((ncol, S, As), dtype=np.int32)
    idx_prev = np.zeros((ncol, C), dtype=np.int32)
    idx_next = np.zeros((ncol, C), dtype=np.int32)

    for ci, col in enumerate(cols):
        p64 = np.array(col.partitions, dtype=np.uint64)
        n = len(p64)
        parts[ci, :n] = p64.view(np.int64)
        n_cells[ci] = n
        depth[ci] = col.depth
        n_sites[ci] = col.length
        a0 = int(offsets[col.ref_start])
        for i, ps in enumerate(col.seqs):
            pt[ci, :a_list[ci], i] = ps.probs[
                a0 - ps.allele_offset:a0 - ps.allele_offset + a_list[ci]]
        for sj, s in enumerate(range(col.ref_start,
                                     col.ref_start + col.length)):
            site = sites[s]
            na = site.allele_number
            site_off[ci, sj] = site.allele_offset - a0
            site_a[ci, sj] = na
            sub[ci, sj, :na, :na] = site.substitution_log_probs
            prior[ci, sj, :na] = site.allele_prior_log_probs
        if ci > 0:
            idx_prev[ci, :n] = merges[ci - 1].prev_idx_array(p64)
        if ci < len(merges):
            idx_next[ci, :n] = merges[ci].next_idx_array(p64)

    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(a).to(dev)
    return RphmmPack(t(parts), t(n_cells), t(depth), t(n_sites), t(pt),
                     t(site_off), t(site_a), t(sub), t(prior), t(idx_prev),
                     t(idx_next), M)


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
