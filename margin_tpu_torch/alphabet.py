"""Nucleotide alphabet: character <-> symbol codes.

Parity: reference impl/stateMachine.c:25-71 (A,C,G,T -> 0..3, everything else
-> 4 == 'N'). Symbols are small ints; vectorized conversion uses a 256-entry
lookup table so whole reads translate in one numpy gather.
"""

from __future__ import annotations

import numpy as np

# 256-entry char->symbol LUT (stateMachine.c:25-42)
_CHAR_TO_SYMBOL = np.full(256, 4, dtype=np.uint8)
for _c, _s in (("A", 0), ("a", 0), ("C", 1), ("c", 1), ("G", 2), ("g", 2),
               ("T", 3), ("t", 3)):
    _CHAR_TO_SYMBOL[ord(_c)] = _s

_SYMBOL_TO_CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)

# Complement in symbol space: A<->T, C<->G, N->N
COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def seq_to_symbols(seq: str | bytes) -> np.ndarray:
    """Convert an ASCII sequence to uint8 symbol codes (0..4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _CHAR_TO_SYMBOL[np.frombuffer(seq, dtype=np.uint8)]


def symbols_to_seq(symbols: np.ndarray) -> str:
    """Convert symbol codes back to an ACGTN string."""
    return _SYMBOL_TO_CHAR[np.asarray(symbols, dtype=np.uint8)].tobytes().decode("ascii")


def reverse_complement_symbols(symbols: np.ndarray) -> np.ndarray:
    return COMPLEMENT[symbols][::-1]


def reverse_complement(seq: str) -> str:
    return symbols_to_seq(reverse_complement_symbols(seq_to_symbols(seq)))


class Alphabet:
    """Nucleotide alphabet object (alphabetSize=5; index 4 is 'N').

    Parity: stateMachine.c:63-71."""

    size = 5

    @staticmethod
    def char_to_symbol(c: str) -> int:
        return int(_CHAR_TO_SYMBOL[ord(c)])

    @staticmethod
    def symbol_to_char(s: int) -> str:
        return "ACGTN"[s] if 0 <= s < 5 else "N"
