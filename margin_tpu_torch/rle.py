"""Run-length-encoded strings and coordinate maps.

Parity: reference impl/rle.c. Design difference: RleString here is backed by
numpy arrays (symbol codes + counts) so RLE/expansion/coordinate maps are
vectorized; ASCII views are derived on demand.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from margin_tpu_torch.alphabet import seq_to_symbols


@dataclass
class RleString:
    """A run-length encoded sequence.

    Attributes:
      bases:   ASCII string of the run-length-compressed sequence.
      counts:  int64 array of per-run repeat counts (len == len(bases)).
      non_rle_length: expanded length (== counts.sum()).

    Parity: rle.c:7-38 (construct), rle.c:64-80 (no-RLE construct).
    """

    bases: str
    counts: np.ndarray
    non_rle_length: int = field(default=0)

    def __post_init__(self):
        self.counts = np.asarray(self.counts, dtype=np.int64)
        if self.non_rle_length == 0:
            self.non_rle_length = int(self.counts.sum())

    # -- constructors --------------------------------------------------------

    @staticmethod
    def encode(raw: str) -> "RleString":
        """Run-length encode a raw string (rle.c:7-38)."""
        if len(raw) == 0:
            return RleString("", np.zeros(0, dtype=np.int64), 0)
        arr = np.frombuffer(raw.encode("ascii"), dtype=np.uint8)
        # boundaries where a new run starts
        starts = np.flatnonzero(np.concatenate(([True], arr[1:] != arr[:-1])))
        ends = np.concatenate((starts[1:], [len(arr)]))
        bases = arr[starts].tobytes().decode("ascii")
        return RleString(bases, (ends - starts).astype(np.int64), len(raw))

    @staticmethod
    def identity(raw: str) -> "RleString":
        """No-op RLE: every run length 1 (rle.c:64-80)."""
        return RleString(raw, np.ones(len(raw), dtype=np.int64), len(raw))

    @staticmethod
    def from_precomputed(bases: str, counts) -> "RleString":
        counts = np.asarray(counts, dtype=np.int64)
        return RleString(bases, counts, int(counts.sum()))

    # -- accessors -----------------------------------------------------------

    @property
    def length(self) -> int:
        return len(self.bases)

    def symbols(self) -> np.ndarray:
        return seq_to_symbols(self.bases)

    def expand(self) -> str:
        """Expand back to the raw string (rle.c:145-155)."""
        if self.length == 0:
            return ""
        arr = np.frombuffer(self.bases.encode("ascii"), dtype=np.uint8)
        return np.repeat(arr, self.counts).tobytes().decode("ascii")

    def substring(self, start: int, length: int) -> "RleString":
        """Copy a sub-RleString (rle.c:82-102)."""
        assert start >= 0 and start + length <= self.length
        return RleString(self.bases[start:start + length],
                         self.counts[start:start + length].copy())

    def copy(self) -> "RleString":
        return RleString(self.bases, self.counts.copy(), self.non_rle_length)

    def __eq__(self, other) -> bool:  # rle.c:115-128
        return (isinstance(other, RleString)
                and self.bases == other.bases
                and self.non_rle_length == other.non_rle_length
                and np.array_equal(self.counts, other.counts))

    # -- coordinate maps -----------------------------------------------------

    def non_rle_to_rle_map(self) -> np.ndarray:
        """raw coordinate -> run index (rle.c:204-216)."""
        return np.repeat(np.arange(self.length, dtype=np.int64), self.counts)

    def rle_to_non_rle_map(self) -> np.ndarray:
        """run index -> raw coordinate of the run start (rle.c:218-229)."""
        out = np.zeros(self.length, dtype=np.int64)
        if self.length > 1:
            out[1:] = np.cumsum(self.counts[:-1])
        return out

    # -- mutation helpers (used by POA left-shift bookkeeping) ---------------

    def rotate(self, rotation_length: int, merge_ends: bool) -> None:
        """In-place circular rotation, optionally merging equal adjacent runs
        (rle.c:157-176)."""
        n = self.length
        if n == 0:
            return
        idx = (np.arange(n) - rotation_length) % n  # rotated[i] = orig[(i - rot) % n]
        rb = np.frombuffer(self.bases.encode("ascii"), dtype=np.uint8)[idx]
        rc = self.counts[idx]
        if not merge_ends:
            self.bases = rb.tobytes().decode("ascii")
            self.counts = rc
            return
        keep = np.concatenate(([True], rb[1:] != rb[:-1]))
        group = np.cumsum(keep) - 1
        merged_counts = np.zeros(int(group[-1]) + 1, dtype=np.int64)
        np.add.at(merged_counts, group, rc)
        self.bases = rb[keep].tobytes().decode("ascii")
        self.counts = merged_counts

    def rle_qualities(self, qualities: np.ndarray) -> np.ndarray:
        """Mean quality per run, truncated mean as in rle.c:178-202."""
        quals = np.asarray(qualities, dtype=np.int64)
        assert quals.shape[0] == self.non_rle_length
        if self.length == 0:
            return np.zeros(0, dtype=np.uint8)
        # run sums via reduceat over the sorted run boundaries (np.add.at
        # is ~20x slower per element)
        starts = np.zeros(self.length, dtype=np.int64)
        if self.length > 1:
            np.cumsum(self.counts[:-1], out=starts[1:])
        sums = np.add.reduceat(quals, starts)
        return (sums // np.maximum(self.counts, 1)).astype(np.uint8)


def run_length_encode_alignment(pairs: np.ndarray,
                                x_map: np.ndarray,
                                y_map: np.ndarray) -> np.ndarray:
    """Re-encode raw-space aligned pairs (x, y[, w]) into RLE space, keeping
    only pairs that advance both coordinates (rle.c:231-251).

    pairs: (N, k>=2) int array sorted in alignment order.
    Returns (M, k) array with columns 0,1 mapped through the coordinate maps.
    """
    pairs = np.asarray(pairs, dtype=np.int64)
    if pairs.size == 0:
        return pairs.reshape(0, pairs.shape[1] if pairs.ndim == 2 else 2)
    out = np.ascontiguousarray(pairs)
    if out is pairs:
        out = pairs.copy()
    out[:, 0] = x_map[pairs[:, 0]]
    out[:, 1] = y_map[pairs[:, 1]]
    # greedy both-coordinates-advance dedup: the kept set feeds its own
    # predicate, so it's inherently sequential — native when available
    # (~20x; the Python loop was ~3 s per 100 kb polish chunk)
    try:
        from margin_tpu_torch.io import native as _native
        L = _native.lib()
    except Exception:
        L = None
    if L is not None:
        m = L.mio_rle_dedup(out, len(out), out.shape[1])
        return out[:m].copy()
    keep = np.zeros(len(out), dtype=bool)
    px, py = -1, -1
    for i in range(len(out)):
        if out[i, 0] > px and out[i, 1] > py:
            keep[i] = True
            px, py = out[i, 0], out[i, 1]
    return out[keep]
