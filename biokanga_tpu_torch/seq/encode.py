"""Copy of biokanga_tpu/seq/encode.py: the base codes and their ASCII form.

Codes are int8: A=0, C=1, G=2, T=3, N=4.  Any comparison involving a code
>= 4 counts as a mismatch.  Only what the port uses is copied.
"""
from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4

# ASCII -> code translation table (uppercase+lowercase; everything else -> N).
_ASCII2CODE = np.full(256, N, dtype=np.int8)
for _ch, _code in (("A", A), ("C", C), ("G", G), ("T", T), ("U", T)):
    _ASCII2CODE[ord(_ch)] = _code
    _ASCII2CODE[ord(_ch.lower())] = _code

_CODE2ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement: A<->T, C<->G, N->N
_COMP = np.array([T, G, C, A, N], dtype=np.int8)


def ascii_to_codes(seq: bytes | bytearray | np.ndarray) -> np.ndarray:
    """ASCII sequence bytes -> int8 code array (vectorised table lookup)."""
    if isinstance(seq, (bytes, bytearray)):
        arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        arr = np.asarray(seq, dtype=np.uint8)
    return _ASCII2CODE[arr]


def codes_to_ascii(codes: np.ndarray) -> bytes:
    codes = np.asarray(codes)
    return _CODE2ASCII[np.clip(codes, 0, 4)].tobytes()


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of an int8 code array (host, numpy)."""
    return _COMP[np.clip(codes[..., ::-1], 0, 4)]
