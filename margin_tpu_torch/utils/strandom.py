"""glibc random() replica for exact-RNG parity with the reference.

The reference consumes randomness through sonLib's `st_random()` (a thin
wrapper over libc rand()) and never seeds, so every run draws from glibc's
default-seed-1 additive-feedback generator (TYPE_3, 31 ints of state).
Reproducing that stream bit-exactly makes the downsampling Bernoulli draws
(downsampleBamChunkReadWithVcfEntrySubstringsViaFullReadLengthLikelihood,
htsIntegration.c:1201) and stList_shuffle identical to the C binary's,
which pins the golden outputs (README.md:176-196) exactly instead of
within a tolerance.

glibc TYPE_3 algorithm (stdlib/random_r.c):
  r[0]   = seed (0 -> 1)
  r[i]   = (16807 * r[i-1]) % 2147483647   for i in 1..30 (Schrage form)
  r[i]   = r[i-31]                          for i in 31..33
  then the generator runs  r[i] = (r[i-3] + r[i-31]) mod 2^32  with the
  first 310 outputs discarded; each output is r[i] >> 1.

Validated against compiled glibc: srand(1) ->
  1804289383, 846930886, 1681692777, 1714636915, ...
"""

from __future__ import annotations

from typing import List, Sequence

_MOD = 1 << 32
RAND_MAX = 2147483647


class GlibcRandom:
    """Bit-exact glibc rand()/random() (TYPE_3) + sonLib-style wrappers."""

    def __init__(self, seed: int = 1):
        self.seed(seed)

    def seed(self, seed: int):
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r: List[int] = [0] * 34
        r[0] = seed
        for i in range(1, 31):
            # (16807 * r[i-1]) % 2147483647 via Schrage to match the C
            # signed-arithmetic implementation
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._state = r  # ring buffer of the last 34 values
        self._idx = 0
        for _ in range(310):
            self._next()

    def _next(self) -> int:
        r = self._state
        i = self._idx
        val = (r[(i + 31) % 34] + r[(i + 3) % 34]) % _MOD
        r[i % 34] = val
        self._idx = (i + 1) % 34
        return val >> 1

    def rand(self) -> int:
        """rand()/random(): uniform int in [0, RAND_MAX]."""
        return self._next()

    def random(self) -> float:
        """st_random(): uniform double in [0, 1)."""
        return self._next() / (RAND_MAX + 1.0)

    def randint(self, lo: int, hi: int) -> int:
        """st_randomInt(min, max): uniform in [min, max) via st_random."""
        if hi <= lo:
            raise ValueError("empty range")
        return lo + int(self.random() * (hi - lo))

    def shuffle(self, items: list):
        """stList_shuffle: for each i, swap with a random index."""
        n = len(items)
        for i in range(n):
            j = self.randint(0, n)
            items[i], items[j] = items[j], items[i]

    # random.Random-compatible state API for the checkpointer
    def getstate(self):
        return ("glibc", tuple(self._state), self._idx)

    def setstate(self, state):
        tag, r, idx = state
        assert tag == "glibc"
        self._state = list(r)
        self._idx = idx


def make_rng(mode: str, seed: int):
    """rng factory for the drivers: 'st' = glibc default-seed stream
    (reference parity; `seed` 0 maps to glibc's unseeded default 1),
    'python' = random.Random(seed) (the round-1 behavior)."""
    if mode == "st":
        return GlibcRandom(seed if seed not in (0, None) else 1)
    import random
    return random.Random(seed)
