"""Copy of biokanga_tpu/seq/encode.py: the base codes and their ASCII form,
the bisulfite collapses and the SOLiD colour transform.

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


# bisulfite collapse tables (SfxArrayV2.cpp:440-459 builds the collapsed
# index copies at SfxBlock2Disk time): CT maps C->T, GA maps G->A
_CT = np.array([A, T, G, T, N], dtype=np.int8)
_GA = np.array([A, C, A, T, N], dtype=np.int8)


def ct_collapse(codes: np.ndarray) -> np.ndarray:
    """Bisulfite C->T collapse (unmethylated-C conversion space)."""
    return _CT[np.clip(codes, 0, 4)]


def ga_collapse(codes: np.ndarray) -> np.ndarray:
    """Bisulfite G->A collapse (the reverse-strand conversion space)."""
    return _GA[np.clip(codes, 0, 4)]


def to_colorspace(codes: np.ndarray) -> np.ndarray:
    """SOLiD colorspace transform of a base-code sequence: color[i] =
    dibase code of (b[i], b[i+1]), which under A=0,C=1,G=2,T=3 is the XOR
    of the two base codes (the reference's colorspace index transform,
    SfxArrayV2.cpp:300-380).  Length L -> L-1; any step touching an N
    yields 4 (no-call '.').  Colors are strand-symmetric: the colorspace
    of the reverse complement is the reversed color string."""
    c = np.asarray(codes, dtype=np.int8)
    a, b = c[:-1], c[1:]
    valid = (a >= 0) & (a < 4) & (b >= 0) & (b < 4)
    return np.where(valid, a ^ b, 4).astype(np.int8)
