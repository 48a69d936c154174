"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` file compiles, on first use, into one shared library
with a plain C interface: one nvcc per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <hash>.d/<name>.o csrc/<name>.cu

then one link, `nvcc ... -shared -o <hash>.so <hash>.d/*.o`.  The library
lands in `build/biokanga_tpu_torch/` at the repository root, named by a
hash of the sources, so an edited source rebuilds and an unchanged one
loads at once.  It is loaded with ctypes: every pointer
and the stream are `c_void_p`, sizes are `c_int` (`c_longlong` where
they may pass 2^31), and every entry point returns `cudaGetLastError()`
after its launch, which `check` turns into an exception.  Nothing here
runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "biokanga_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PP = ctypes.POINTER(_P)        # an array of pointers
_PL = ctypes.POINTER(_L)
# C entry points: name -> argument types (all return cudaError_t as int)
_SIGNATURES = {
    # (x, out, B, C, stream)
    "sort_rows_i32": (_P, _P, _I, _I, _P),
    # (x, out, scratch, B, C, P, stream)
    "sort_rows_wide_i32": (_P, _P, _P, _I, _I, _L, _P),
    # (key, val, out_key, out_val, B, C, stream)
    "sort2_rows_i32": (_P, _P, _P, _P, _I, _I, _P),
    # (key, val, out_key, out_val, scratch, B, C, P, stream)
    "sort2_rows_wide_i32": (_P, _P, _P, _P, _P, _I, _I, _L, _P),
    # (rows, n_rows, R, genome_len, entry_starts, n_starts, loci, valid,
    #  rcodes, rnlane, lengths, out, B, C, W, stream)
    "hamming_extend_packed": (_P, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P,
                              _P, _I, _I, _I, _P),
    # (a, bwin, alen, jlo, jhi, best, best_i, best_k, mv or NULL,
    #  scratch or NULL, B, La, T, W, match, mismatch, gap_open, gap_ext,
    #  stream)
    "banded_sw": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                  _I, _I, _I, _P),
    # (W, moves, *ints): int32 of device-memory state a pair
    "banded_sw_scratch": (_I, _I, ctypes.POINTER(_L)),
    # (rows, n_rows, R, genome_len, entry_starts, n_starts, loci, valid,
    #  rcodes, rnlane, win, out, B, C, W, stream)
    "hamming_extend_packed_win": (_P, _P, _I, _I, _P, _I, _P, _P, _P, _P,
                                  _P, _P, _I, _I, _I, _P),
    # (mv, best_i, best_k, bwin, out, ins_cnt, ins_base, B, La, Wd, K, T,
    #  stream)
    "sw_trace_packed": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # (table, idx, n, R, region_rows, out, stream)
    "stream_gather_consume": (_P, _P, _I, _I, _I, _P, _P),
    # (*bytes): the current device's L2 size
    "stream_gather_l2_bytes": (ctypes.POINTER(_I),),
    # (a, b, words, pad, hmin, n, K, d_lo, d_hi, cross, stream)
    "uhamming_sweep": (_P, _P, _L, _L, _P, _L, _I, _L, _L, _I, _P),
    # (q0, t0, ln, score, valid, f, pred, scratch or NULL, C, M, gap_open,
    #  stream)
    "blitz_chain": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # (): the widest chain whose rows stay in shared memory
    "blitz_chain_shared_max_m": (),
    # (steps, out, stream): one warp of the chain DP's dependent steps
    "blitz_chain_step_probe": (_I, _P, _P),
    # (reads, lengths, offs, B, L, S, core_len, H, rc, occ_skip, owned,
    #  key_hi, key_lo, n_keys, lut, lut_bases, steps, pos, n_pos, flat,
    #  overflow, stream)
    "seed_rows": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _P, _P, _L, _P,
                  _I, _I, _P, _L, _P, _P, _P),
    # (srt, overflow, reads, lengths, B, SH, S, C, L, W, rc, occ_skip, loci,
    #  valid, n_over, trunc, rcodes, rnlane, stream)
    "dedup_pack": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                   _P, _P, _P, _P),
    # (fast[13], fast_stride[13], classic[13], classic_stride[13], out[13],
    #  lengths, B, Kml, fast_core, fast_read_len, core_len, med, flagged,
    #  unresolved, stream)
    "select_chunk": (_PP, _PL, _PP, _PL, _PP, _P, _I, _I, _I, _I, _I, _I, _P,
                     _P, _P),
    # (stage[13], out[13], base, lengths, K, B, Kml, rate, budget, med, err,
    #  stream)
    "merge_chunks": (_PP, _PP, _P, _P, _I, _I, _I, ctypes.c_double, _I, _I,
                     _P, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {CSRC}")
    return srcs


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise FileNotFoundError("nvcc not found on PATH or under CUDA_HOME")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbiokanga_tpu_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        text = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + text)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the sources if no library for their hash exists yet."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    objdir = out.with_suffix(f".{os.getpid()}.d")
    objdir.mkdir(parents=True, exist_ok=True)
    objs = [objdir / (src.stem + ".o") for src in _sources()]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(_sources(), objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    os.replace(tmp, out)
    shutil.rmtree(objdir, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.biokanga_cuda_error_string.argtypes = [ctypes.c_int]
            lib.biokanga_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().biokanga_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {err} ({msg})")


def stream_ptr(device) -> int:
    """Raw handle of PyTorch's current stream on `device`, read without
    building a `torch.cuda.Stream` (a few microseconds a launch)."""
    import torch

    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
