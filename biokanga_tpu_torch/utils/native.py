"""Copy of biokanga_tpu/utils/native.py: ctypes loader for the native host
runtime (native/kanga_native.cpp).

The library is compiled with g++ on first use into the gitignored
`build/biokanga_tpu_torch/native/` directory at the repository root; the
tracked `native/` directory is only read.  It is built for the generic
x86-64 target, not `-march=native`, because a working tree (build
directory included) may be copied to another machine.  Every entry point
returns None when the library cannot be built or loaded, and its callers
then take their numpy path, as in the JAX package.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "native" / "kanga_native.cpp"
_OUT = _ROOT / "build" / "biokanga_tpu_torch" / "native" / "libkanga_native.so"


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not _OUT.exists()
                    or _OUT.stat().st_mtime < _SRC.stat().st_mtime):
                _OUT.parent.mkdir(parents=True, exist_ok=True)
                tmp = _OUT.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC",
                     "-std=c++17", "-pthread", str(_SRC), "-o", str(tmp)],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, _OUT)
            lib = ctypes.CDLL(str(_OUT))
        except (OSError, subprocess.SubprocessError):
            return None

        i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32

        lib.build_keys.argtypes = [i8p, i64, u32p, u32p, i32]
        lib.sort_positions.argtypes = [u32p, u32p, i32p, i64, i32]
        lib.gather_keys.argtypes = [u32p, u32p, i32p, i64, u32p, u32p, i32]
        lib.parse_fastq_block.argtypes = [
            ctypes.c_char_p, i64, i8p, i32p, ctypes.c_void_p, i64p, i32p,
            i64, i64, ctypes.POINTER(i64),
        ]
        lib.parse_fastq_block.restype = i64
        _lib = lib
        return _lib


def native_threads() -> int:
    return max(1, os.cpu_count() or 1)


def build_sorted_keys(codes: np.ndarray):
    """(pos_sorted, key_hi_sorted, key_lo_sorted) via the native path,
    or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(codes)
    hi = np.empty(n, np.uint32)
    lo = np.empty(n, np.uint32)
    c = np.ascontiguousarray(codes, np.int8)
    T = native_threads()
    lib.build_keys(c, n, hi, lo, T)
    pos = np.empty(n, np.int32)
    lib.sort_positions(hi, lo, pos, n, T)
    hi_s = np.empty(n, np.uint32)
    lo_s = np.empty(n, np.uint32)
    lib.gather_keys(hi, lo, pos, n, hi_s, lo_s, T)
    return pos, hi_s, lo_s


def parse_fastq_native(buf: bytes, max_reads: int, max_len: int,
                       with_quals: bool = True):
    """Parse a FASTQ byte buffer into a padded block, or None."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.full((max_reads, max_len), 4, np.int8)
    lengths = np.zeros(max_reads, np.int32)
    quals = np.zeros((max_reads, max_len), np.uint8) if with_quals else None
    name_ofs = np.zeros(max_reads, np.int64)
    name_len = np.zeros(max_reads, np.int32)
    consumed = ctypes.c_int64(0)
    qp = quals.ctypes.data_as(ctypes.c_void_p) if with_quals else None
    n = lib.parse_fastq_block(
        buf, len(buf), codes, lengths, qp, name_ofs, name_len,
        max_reads, max_len, ctypes.byref(consumed),
    )
    n = int(n)
    names = [
        buf[name_ofs[i] : name_ofs[i] + name_len[i]].decode()
        for i in range(n)
    ]
    return (names, codes[:n], lengths[:n],
            quals[:n] if with_quals else None, int(consumed.value))
