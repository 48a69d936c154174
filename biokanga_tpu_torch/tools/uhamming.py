"""Port of biokanga_tpu/tools/uhamming.py: the genome-wide minimum
Hamming distance sweep (`uhamming`, uhamming/uhamming.cpp).

For every locus, the least Hamming distance between its K-window and
every other K-window of the genome, and, with the reverse complement,
every window of the other strand.  The sweep runs by shift: kernel #7
(ops/uhamming_sweep.py, csrc/uhamming_sweep.cu) on the card, its plain
version on the CPU.  Shift ranges partition the sweep across nodes as
the reference's -n/-N static ranges do (mode 2), and partial minima merge
by elementwise minimum (mode 3).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..device import resolve_device
from ..ops.uhamming_sweep import H_INVALID, uhamming_sweep


def window_validity(entry_starts: np.ndarray, n: int, K: int) -> np.ndarray:
    """valid[i] == window [i, i+K) fully inside one entry."""
    valid = np.zeros(n, dtype=bool)
    for e in range(len(entry_starts) - 1):
        a, b = int(entry_starts[e]), int(entry_starts[e + 1])
        if b - a >= K:
            valid[a : b - K + 1] = True
    return valid


def hamming_sweep(
    codes: np.ndarray,
    entry_starts: np.ndarray,
    K: int = 100,
    shift_lo: int = 1,
    shift_hi: int | None = None,
    include_rc: bool = True,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Min-Hamming per locus over shifts [shift_lo, shift_hi), and over
    every reverse-complement window with include_rc; (n,) uint8."""
    n = len(codes)
    if shift_hi is None:
        shift_hi = n - K + 1
    shift_hi = min(shift_hi, n - K + 1)
    dev = resolve_device(device)
    g = torch.from_numpy(np.ascontiguousarray(codes, np.int8)).to(dev)
    valid = torch.from_numpy(window_validity(entry_starts, n, K)).to(dev)
    hmin = torch.full((n,), H_INVALID, dtype=torch.uint8, device=dev)
    hmin = uhamming_sweep(g, valid, hmin, K, shift_lo, shift_hi, include_rc)
    return hmin.cpu().numpy()


def merge_partials(partials: list[np.ndarray]) -> np.ndarray:
    """Mode-3 merge of per-node partial minima (uhamming.cpp:222)."""
    out = partials[0].copy()
    for p in partials[1:]:
        np.minimum(out, p, out=out)
    return out


def save_hmg(path: str, hmin: np.ndarray, entry_names, entry_starts, K: int):
    meta = {"K": K, "entry_names": list(entry_names)}
    np.savez(path, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             hmin=hmin, entry_starts=np.asarray(entry_starts))


def load_hmg(path: str):
    with np.load(path) as z:
        meta = json.loads(z["meta"].tobytes().decode())
        return z["hmin"], meta["entry_names"], z["entry_starts"], meta["K"]


def write_hamming_csv(path: str, hmin, entry_names, entry_starts):
    """CSV transform (role of the HammingDist tool, HammingDist/)."""
    starts = np.asarray(entry_starts)
    with open(path, "w") as f:
        f.write('"Chrom","Loci","Hamming"\n')
        for e, name in enumerate(entry_names):
            a, b = int(starts[e]), int(starts[e + 1])
            for i in range(a, b):
                if hmin[i] != H_INVALID:
                    f.write(f'"{name}",{i - a},{int(hmin[i])}\n')
