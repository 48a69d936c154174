"""Port of biokanga_tpu/chromatin/conformation.py: the octamer
conformational-parameter model, with its profile gather in torch on the
caller's device.

Reference semantics: CConformation::LoadStructOctamersParams
(libbiokanga/Conformation.cpp:45) parses a CSV of 65,536 octamer rows,
each carrying 22 structural characteristics
(twist..shift, tri-step variants, energy, minor groove, rmsd, Q+/Q-
angles, ORChID); CTwister::GetStructParams (libbiokanga/Twister.cpp)
then walks a sequence step-by-step, returning the octamer-indexed value
for each dinucleotide step, interpolating the first/last 3 steps by
padding with eBaseA (Twister.h `Interpolate`).

The whole profile is one gather: the A-padded step octamer indices are
computed on the device with a polynomial accumulation (MSB-first,
matching the reference's GenSeqIdx, gencomposition.cpp:933-945), then
`index_select` pulls the per-step values from the parameter column, a
65,536-entry float32 tensor on the same device.  On the CPU the same
torch code is the plain version.  The table loader and the oligo
indices of the host tools stay numpy, as in the JAX module.
"""
from __future__ import annotations

import numpy as np
import torch

# column order exactly as parsed by LoadStructOctamersParams's sscanf
# (Conformation.cpp:103-109): 10 step params then 12 supplementary.
OCT_PARAM_NAMES = [
    "twist", "roll", "tilt", "rise", "slide", "shift",
    "tristeptwist", "tristeproll", "tristepslide", "tristepshift",
    "energy", "minorgroove", "rmsd",
    "qminustwist", "qplustwist", "qminusroll", "qplusroll",
    "triqminustwist", "triqplustwist", "triqminusroll", "triqplusroll",
    "orchid",
]
N_OCT = 4 ** 8  # 65536

_ACGT = np.full(256, -1, dtype=np.int64)
for _i, _c in enumerate("ACGT"):
    _ACGT[ord(_c)] = _i
    _ACGT[ord(_c.lower())] = _i


def octamer_to_idx(octamer: str) -> int:
    """Octamer string -> MSB-first 16-bit index (GenSeqIdx convention)."""
    vals = _ACGT[np.frombuffer(octamer.encode(), dtype=np.uint8)]
    if len(vals) != 8 or (vals < 0).any():
        raise ValueError(f"bad octamer {octamer!r}")
    return int(np.dot(vals, 4 ** np.arange(7, -1, -1)))


def idx_to_oligo(idx: int, k: int) -> str:
    """Inverse of GenSeqIdx for a k-mer (reference StepIdx2Seq role)."""
    out = []
    for shift in range(2 * (k - 1), -2, -2):
        out.append("ACGT"[(idx >> shift) & 3])
    return "".join(out)


def load_octamer_params(path: str) -> np.ndarray:
    """Parse an octamer structural-parameters CSV into a (65536, 22)
    float32 table (LoadStructOctamersParams file contract: octamer then
    22 comma-separated doubles; whitespace/quotes stripped; a first line
    that fails to parse is treated as a header)."""
    table = np.zeros((N_OCT, len(OCT_PARAM_NAMES)), dtype=np.float32)
    seen = np.zeros(N_OCT, dtype=bool)
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = "".join(
                ch for ch in line if not ch.isspace() and ch not in "'\"")
            if len(line) < 5:
                continue
            parts = line.split(",")
            try:
                idx = octamer_to_idx(parts[0])
                vals = [float(v) for v in parts[1:23]]
            except (ValueError, IndexError):
                if not seen.any():
                    continue  # header line
                raise ValueError(f"{path}:{lineno}: unparseable params row")
            if len(vals) != 22:
                raise ValueError(
                    f"{path}:{lineno}: expected 23 fields, got "
                    f"{len(vals) + 1}")
            if seen[idx]:
                raise ValueError(f"{path}:{lineno}: duplicate octamer")
            seen[idx] = True
            table[idx] = vals
    return table


def oligo_indices(codes: np.ndarray, k: int) -> np.ndarray:
    """Sliding k-mer indices over an int8 code sequence.

    Returns int32 array of len(codes)-k+1 entries; -1 where any base in
    the window is not ACGT (GenSeqIdx returns -1 on 'N').
    """
    codes = np.asarray(codes)
    n = codes.size - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    c = codes.astype(np.int64)
    valid = c < 4
    cm = np.where(valid, c, 0)
    idx = np.zeros(n, dtype=np.int64)
    ok = np.ones(n, dtype=bool)
    for j in range(k):
        idx = (idx << 2) | cm[j:j + n]
        ok &= valid[j:j + n]
    return np.where(ok, idx, -1)


def octamer_indices_t(padded: torch.Tensor) -> torch.Tensor:
    """Sliding octamer indices (int64, -1 where the window holds a code
    >= 4) over an int8 tensor of codes, on its device: the torch form of
    oligo_indices(padded, 8)."""
    n = padded.numel() - 7
    c = padded.to(torch.int64)
    valid = c < 4
    cm = torch.where(valid, c, torch.zeros_like(c))
    idx = torch.zeros(n, dtype=torch.int64, device=padded.device)
    ok = torch.ones(n, dtype=torch.bool, device=padded.device)
    for j in range(8):
        idx = (idx << 2) | cm[j:j + n]
        ok &= valid[j:j + n]
    return torch.where(ok, idx, torch.full_like(idx, -1))


def pad_steps(codes: np.ndarray) -> np.ndarray:
    """codes with three A's (code 0) on each side: the flanks that
    CTwister::Interpolate fills with eBaseA (Twister.h:22-24)."""
    codes = np.asarray(codes)
    pad = np.zeros(3, dtype=codes.dtype)
    return np.concatenate([pad, codes, pad])


def step_octamer_indices(codes: np.ndarray,
                         device: torch.device) -> torch.Tensor:
    """Octamer index for each dinucleotide step 0..len-2, computed on
    `device` (int64 tensor there; -1 where the window holds an N).

    Step i is the step between bases i and i+1, scored from the octamer
    codes[i-3 .. i+4]; edge steps pad with base A exactly as the
    reference's CTwister::Interpolate fills missing flank bases with
    eBaseA (Twister.h:22-24).
    """
    codes = np.asarray(codes)
    if codes.size < 2:
        return torch.zeros(0, dtype=torch.int64, device=device)
    padded = torch.from_numpy(
        np.ascontiguousarray(pad_steps(codes), dtype=np.int8)).to(device)
    return octamer_indices_t(padded)[: codes.size - 1]


def param_column(table: np.ndarray, param: str | int,
                 device: torch.device) -> torch.Tensor:
    """The (65536,) float32 column of `param` as a tensor on `device`."""
    col = (OCT_PARAM_NAMES.index(param) if isinstance(param, str) else param)
    return torch.from_numpy(np.ascontiguousarray(table[:, col])).to(device)


def gather_column(column: torch.Tensor, idx: torch.Tensor,
                  undef_value: float = 0.0) -> torch.Tensor:
    """column[idx] with `undef_value` where idx < 0, on idx's device: the
    one device op of the profile (jnp.take in the JAX module).  Each call
    on a CUDA tensor adds one to `gather_column.launches`."""
    if idx.device.type == "cuda":
        gather_column.launches += 1
    out = column.index_select(0, idx.clamp(min=0))
    return out.masked_fill_(idx < 0, undef_value)


gather_column.launches = 0


def gather_steps(column: torch.Tensor, idx: torch.Tensor,
                 undef_value: float = 0.0) -> np.ndarray:
    """gather_column's float32 result, copied to the host as numpy."""
    return gather_column(column, idx, undef_value).cpu().numpy()


def conformation_profile(codes: np.ndarray, table: np.ndarray,
                         param: str | int, undef_value: float = 0.0, *,
                         device: torch.device) -> np.ndarray:
    """Per-step structural-property profile of a sequence (float32).

    One gather over the octamer table on `device`; steps whose octamer
    window holds an indeterminate base return `undef_value` (reference
    returns the UndefBaseValue sentinel, Twister.h GetStructParam).
    The JAX module gathers on its device only from 2^18 steps
    (`_DEVICE_GATHER_MIN`), a TPU dispatch choice; a gather is exact, so
    this one runs on `device` at every size with the same result.
    """
    idx = step_octamer_indices(codes, device)
    return gather_steps(param_column(table, param, device), idx, undef_value)


def profile_stats(profile: np.ndarray) -> dict:
    """Mean/min/max/stddev summary (reference tsStructStats,
    Twister.h:9-15, values scaled there by 1e4; we keep floats)."""
    if profile.size == 0:
        return {"mean": 0.0, "min": 0.0, "max": 0.0, "stddev": 0.0}
    return {
        "mean": float(profile.mean()),
        "min": float(profile.min()),
        "max": float(profile.max()),
        "stddev": float(profile.std()),
    }
