#!/usr/bin/env python3
"""How far the summation order moves the Baum-Welch transition
expectations of one deep banded problem, on the CPU.

    python3 scripts/expectation_sums.py [--lx 4060] [--width 208]
                                        [--chunk 46]

Builds chip_smoke.k5_pack's pair (lx bases anchored every 6 at the band
width, ~2 lx diagonals), walks margin_tpu_torch's plain backward
(cuda_banded._bwd_step, the twin of K4 and K5-exp) and keeps every band
cell's nine float32 terms exp(f[from] + to[to] + t[from, to] - total).
Then it sums the same terms in four orders:

  float64      the exact sum of the same terms;
  float32 acc  margin_tpu's, and the port's plain twin's: each diagonal's
               band sum added into a float32 (3, 3) accumulator
               (ops/banded.py:478-486);
  lane running each lane (band cell) its own float32 running sums over
               every diagonal, then the warps' butterfly and the warps in
               order: the kernels' (K4 and both designs of K5-exp);
  lane chunked each lane's sums of `--chunk` diagonals added into its
               running sums: nearer the float64 sum, and so farther from
               margin_tpu's, than the kernels' order;

and prints, for each, the largest |difference| from the float64 sum and
from the float32 accumulator's, as a share of the kernels' tolerance
(rtol 1e-5, atol 1e-7 x the matrix sum; chip_smoke.compare_expectations).
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def terms_of(pack, use_lut=True):
    """(D, 3, 3, W) float32 terms of pack's problem 0, in walk order."""
    import torch
    from margin_tpu_torch.ops import cuda_banded as cb
    fwd, totals = cb.fb_forward_plain(pack, use_lut)
    sw = cb._Sweep(pack, "bwd", use_lut)
    P = sw.P
    tmat = pack.trans[:, torch.tensor(cb._TMAT)][..., None]
    to_order = torch.tensor(cb._TO_ORDER)
    f_rows = P.rows.clamp(max=pack.n_rows - 1)
    next1 = next2 = cb._padded(sw.empty())
    bwd_final = cb._bwd_final(pack, sw)
    total = totals[:, None, None, None]
    zero = torch.zeros(())
    out = []
    for g in range(P.Dmax - 1, -1, -1):
        _, vm, cur, to = cb._bwd_step(sw, g, next1, next2, bwd_final)
        f = fwd[f_rows[:, g]]
        to = to.index_select(1, to_order)
        contrib = torch.exp(f[:, :, None, :] + to[:, None, :, :] + tmat
                            - total)
        out.append(torch.where(vm[:, :, None, :], contrib, zero)[0].numpy())
        next2, next1 = next1, cb._padded(cur)
    import numpy as np
    return np.stack(out).astype(np.float32)


def lane_reduce(lanes):
    """(lanes, 3, 3) float32 -> a warp's butterfly (xor 16, 8, 4, 2, 1),
    then the warps' sums in order, as the kernels reduce."""
    import numpy as np
    out = np.zeros((3, 3), np.float32)
    for w in range(lanes.shape[0] // 32):
        v = lanes[32 * w:32 * w + 32].copy()
        o = 16
        while o:
            v = (v + v[np.arange(32) ^ o]).astype(np.float32)
            o >>= 1
        out = (out + v[0]).astype(np.float32)
    return out


def lane_sums(T, chunk):
    """Each lane's sums of `chunk` diagonals added into its running sums
    (chunk >= the depth: one running sum over every diagonal)."""
    import numpy as np
    D, W = T.shape[0], T.shape[-1]
    lanes = -(-W // 32) * 32
    cells = np.zeros((D, lanes, 3, 3), np.float32)
    cells[:, :W] = np.moveaxis(T, -1, 1)
    run = np.zeros((lanes, 3, 3), np.float32)
    for c0 in range(0, D, chunk):
        part = np.zeros((lanes, 3, 3), np.float32)
        for g in range(c0, min(D, c0 + chunk)):
            part = (part + cells[g]).astype(np.float32)
        run = (run + part).astype(np.float32)
    return lane_reduce(run)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lx", type=int, default=4060)
    ap.add_argument("--width", type=int, default=208)
    ap.add_argument("--chunk", type=int, default=46,
                    help="diagonals a chunk (K2's deepest chunk at W = 208, "
                         "RLE off: 46)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import chip_smoke
    torch.set_num_threads(4)
    pack = chip_smoke.k5_pack("cpu", args.width, False, (args.lx,))
    T = terms_of(pack)
    exact = T.astype(np.float64).sum(axis=(0, 3))
    acc = np.zeros((3, 3), np.float32)
    for g in range(T.shape[0]):
        acc = (acc + T[g].sum(axis=-1, dtype=np.float32)).astype(np.float32)

    def share(got, want):
        tol = 1e-5 * np.abs(want) + 1e-7 * want.sum()
        return float((np.abs(got - want) / tol).max())
    print(f"pack W={pack.W}, {T.shape[0]} diagonals; largest |diff| as a "
          "share of the tolerance, from the float64 sum / from the float32 "
          "accumulator's:")
    for name, got in (("float32 acc", acc),
                      ("lane running", lane_sums(T, T.shape[0])),
                      (f"lane chunked ({args.chunk})",
                       lane_sums(T, args.chunk))):
        print(f"  {name:22s} {share(got, exact):.3f} / {share(got, acc):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
