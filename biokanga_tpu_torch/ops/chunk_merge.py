"""The resident chunked path's per-chunk select and exact merge across
chunks (parallel/chunked.py `ChunkedAligner`), on the results' device.

    stage = staging(K, B, Kml, device)
    select_chunk(stage, k, lengths, classic, dp, med, fast=None, fp=None)
    merge_chunks(stage, base, lengths, max_subs_per100, med) -> dict

A staging set holds one slot a chunk of a block's result: the 13 FIELDS
(align/pipeline.py RESULT_KEYS, then the ladder keys) as (K, B) or (K,
B, Kml) tensors of the engine's dtypes, and `counts`, (3, K) int32: the
rows of each chunk that the rescue ladder would take (row 0), its rows
the fast pass left unresolved (row 1), and, at [2, 0], a flag set where
a global locus fell outside [0, 2^42).  Zero `counts` before a block.

`select_chunk` writes chunk k's slot from its passes' results (dicts of
tensors, read where they lie): with a fast pass, a row it resolves
(align/pipeline.py `resolved_rows` under the FastPassParams `fp`) takes
its RESULT_KEYS and zero ladder keys, any other row the classic pass's
fields; without one, every row takes `classic`.  It
adds the chunk's counts: the rows `inexact_rows` would find under the
classic pass's DerivedParams `dp`, and the unresolved rows where there
is a fast pass.  `merge_chunks` merges the K slots by the rule of
parallel/chunked.py's module doc (`merge_chunk_results`, field for
field): a dict of the 13 fields on the device, loci int64 and global.

On a CUDA tensor each wrapper launches its entry of csrc/chunk_merge.cu
(see the source note there) and counts it in its `launches`; on a CPU
tensor it runs its plain version (`select_chunk_plain`: pipeline's
`resolved_rows` and `inexact_rows` on the tensors' numpy views and torch
selects; `merge_chunks_plain`, torch ops, and `one_chunk` for a single
chunk).  A merge on the CPU raises on a locus outside [0, 2^42); on the
card the caller reads the flag in `counts`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..align.pipeline import inexact_rows, resolved_rows
from .extend_packed import MM_INVALID

FIELDS = ("unique", "any_hit", "best_mm", "next_mm", "inst", "locus",
          "is_rc", "ml_loci", "ml_mm", "ml_rc", "overflow", "n_over",
          "cap_trunc")
_LADDER = FIELDS[10:]
_MULTI = ("ml_loci", "ml_mm", "ml_rc")
DTYPES = {"unique": torch.bool, "any_hit": torch.bool,
          "best_mm": torch.uint8, "next_mm": torch.uint8,
          "inst": torch.int32, "locus": torch.int32, "is_rc": torch.bool,
          "ml_loci": torch.int32, "ml_mm": torch.uint8, "ml_rc": torch.bool,
          "overflow": torch.bool, "n_over": torch.int32,
          "cap_trunc": torch.bool}


def max_tot_mm(lengths: np.ndarray, max_subs_per100: int) -> np.ndarray:
    """Per-read mismatch budget of the merge, in float64 as numpy rounds
    it."""
    if max_subs_per100 == 0:
        return np.zeros(len(lengths), np.int32)
    return np.clip(
        np.floor(lengths * (max_subs_per100 / 100.0) + 0.5), 1, 63
    ).astype(np.int32)


def staging(K: int, B: int, Kml: int, device) -> dict:
    """An empty staging set of K slots of B rows."""
    out = {k: torch.empty((K, B, Kml) if k in _MULTI else (K, B),
                          dtype=DTYPES[k], device=device) for k in FIELDS}
    out["counts"] = torch.zeros((3, K), dtype=torch.int32, device=device)
    return out


def select_chunk_plain(stage, k, lengths, classic, dp, med, fast=None,
                       fp=None) -> None:
    """select_chunk on CPU tensors."""
    def keys(res):
        return {key: res[key].numpy() for key in _LADDER[1:] + ("best_mm",)}

    ln = lengths.numpy()
    resolved = (np.zeros(len(ln), bool) if fast is None
                else resolved_rows(keys(fast), ln, fp, med))
    inexact = inexact_rows(keys(classic) | {"derived": dp}, ln, med)
    r = torch.from_numpy(resolved)
    for key in FIELDS:
        c = classic[key]
        take = (fast[key] if fast is not None and key not in _LADDER
                else torch.zeros_like(c))
        stage[key][k] = torch.where(r.view(-1, *([1] * (c.dim() - 1))),
                                    take, c)
    stage["counts"][0, k] += int((~resolved & inexact).sum())
    if fast is not None:
        stage["counts"][1, k] += int((~resolved).sum())


def _fields(res: dict, B: int, Kml: int, device, arg: str):
    """(pointers, row strides, tensors) of a pass's result for the
    kernel, each tensor checked for its dtype and shape; hold the tensors,
    which may be copies, until the kernel is enqueued."""
    ptrs, strides, held = [], [], []
    for key in FIELDS:
        t = res[key]
        shape = (B, Kml) if key in _MULTI else (B,)
        if (t.dtype != DTYPES[key] or tuple(t.shape) != shape
                or t.device != device):
            raise ValueError(f"select_chunk: {arg}[{key!r}] is "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"want {shape} {DTYPES[key]} on {device}")
        if key in _MULTI and t.stride(1) != 1:
            t = t.contiguous()
        ptrs.append(t.data_ptr())
        strides.append(t.stride(0))
        held.append(t)
    return ((ctypes.c_void_p * len(FIELDS))(*ptrs),
            (ctypes.c_longlong * len(FIELDS))(*strides), held)


def _slots(stage: dict, k: int | None = None):
    """The staging fields' pointers, of chunk k's slots where k is given."""
    return (ctypes.c_void_p * len(FIELDS))(*(
        (stage[key] if k is None else stage[key][k]).data_ptr()
        for key in FIELDS))


def select_chunk(stage: dict, k: int, lengths: torch.Tensor, classic: dict,
                 dp, med: int, fast: dict | None = None, fp=None) -> None:
    """Write chunk k's slot of `stage` and add its counts; see the
    module's note."""
    K, B = stage["best_mm"].shape
    Kml = stage["ml_mm"].shape[2]
    dev = lengths.device
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"select_chunk: lengths is {tuple(lengths.shape)} "
                         f"{lengths.dtype}, want ({B},) int32")
    if (fast is None) != (fp is None) or not 0 <= k < K:
        raise ValueError("select_chunk: give fast with fp, and k in "
                         f"[0, {K})")
    if dev.type == "cpu":
        return select_chunk_plain(stage, k, lengths, classic, dp, med, fast,
                                  fp)
    c_ptrs, c_strides, c_held = _fields(classic, B, Kml, dev, "classic")
    f_ptrs, f_strides, f_held = (_fields(fast, B, Kml, dev, "fast")
                                 if fast is not None
                                 else (c_ptrs, c_strides, c_held))
    if B:
        counts = stage["counts"]
        lib = kernels.library()
        with torch.cuda.device(dev):
            err = lib.select_chunk(
                f_ptrs, f_strides, c_ptrs, c_strides, _slots(stage, k),
                lengths.contiguous().data_ptr(), B, Kml,
                0 if fp is None else fp.dp.core_len,
                0 if fp is None else fp.dp.read_len, dp.core_len, med,
                counts[0, k].data_ptr(), counts[1, k].data_ptr(),
                kernels.stream_ptr(dev))
        kernels.check(err, "select_chunk")
        select_chunk.launches += 1


select_chunk.launches = 0


def merge_chunks_plain(f: dict, base: torch.Tensor, mtm: torch.Tensor,
                       med: int) -> dict:
    """The exact merge of K >= 2 chunks' results (`f`: each field's (K,
    ...) tensor; `base`: (K,) int64 chunk bases; `mtm`: (B,) int32
    mismatch budgets), in torch ops on their device."""
    best = f["best_mm"].to(torch.int32)
    nxt = f["next_mm"].to(torch.int32)
    inst = f["inst"]
    rc = f["is_rc"]
    loc_g = f["locus"].to(torch.int64) + base[:, None]
    ovf = f["overflow"].any(dim=0)
    # skip-aware exactness composition: a hidden hit lives in ONE chunk,
    # so the per-read pigeonhole charge is the worst chunk's skip count;
    # cap truncation anywhere taints the row
    n_over = f["n_over"].amax(dim=0)
    cap_trunc = f["cap_trunc"].any(dim=0)

    # winner chunk by lexicographic (mm, strand, global locus), the first
    # chunk on ties: one argmin over the pair packed in an int64 (global
    # loci of up to 2^42 bases, past BioKanga's 1,000 Gbp of target)
    okey = best * 2 + rc                           # (K, B)
    if int(loc_g.min()) < 0 or int(loc_g.max()) >= 1 << 42:
        raise ValueError("chunk loci outside [0, 2^42)")
    kstar = torch.argmin((okey.to(torch.int64) << 42) | loc_g, dim=0)

    def take(t):
        return t.gather(0, kstar[None]).squeeze(0)

    b_star = take(best)
    is_best = best == b_star[None, :]
    inst_star = torch.where(is_best, inst, 0).sum(dim=0, dtype=torch.int64)
    # rows with NO valid candidate anywhere (best == MM_INVALID): inst is
    # the invalid-slot count, not a hit count — keep the winner's verbatim
    # so the merged dict matches the single-index output bit-for-bit
    inst_star = torch.where(b_star >= MM_INVALID, take(inst).to(torch.int64),
                            inst_star)
    # union second-smallest: best* itself when the union holds >= 2 best
    # instances (matches the single-index sorted-duplicates semantics)
    next_star = torch.where(is_best, nxt, best).amin(dim=0)
    next_star = torch.where(inst_star >= 2, b_star, next_star)
    # per-chunk next_mm arrives saturated at chunk_best + MMDelta; the
    # min-merge then re-saturates at global best + MMDelta — equal to
    # saturate(true union second-best) because chunk bests are never
    # saturated and any sub-margin union value is sub-margin in its own
    # chunk
    next_star = torch.minimum(next_star, b_star + med)

    any_hit = b_star <= mtm
    unique = any_hit & ((next_star - b_star) >= med)

    # top-K multi-hit merge: K-smallest of the union by (mm, rc, locus),
    # ties in chunk order
    K, B, Kml = f["ml_mm"].shape

    def union(t):
        return t.permute(1, 0, 2).reshape(B, K * Kml)

    ml_mm = union(f["ml_mm"])
    ml_rc = union(f["ml_rc"])
    ml_loc = f["ml_loci"].to(torch.int64)
    ml_loc = union(torch.where(ml_loc >= 0, ml_loc + base[:, None, None], -1))
    comp = (((ml_mm.to(torch.int64) * 2 + ml_rc) << 44)
            | ml_loc.clamp(0, (1 << 44) - 1))
    order = torch.sort(comp, dim=1, stable=True).indices[:, :Kml]
    return {
        "unique": unique,
        "any_hit": any_hit,
        "best_mm": b_star.clamp(max=MM_INVALID).to(torch.uint8),
        "next_mm": next_star.clamp(max=MM_INVALID).to(torch.uint8),
        "inst": inst_star.to(inst.dtype),
        "locus": take(loc_g),
        "is_rc": (take(okey) & 1).to(torch.bool),
        "overflow": ovf,
        "n_over": n_over,
        "cap_trunc": cap_trunc,
        "ml_loci": ml_loc.gather(1, order),
        "ml_mm": ml_mm.gather(1, order),
        "ml_rc": ml_rc.gather(1, order),
    }


def one_chunk(part: dict, base: int) -> dict:
    """A single chunk's host result as the merge gives it: its own, loci
    moved by its base."""
    p = dict(part)
    p["locus"] = p["locus"].astype(np.int64) + base
    ml = p["ml_loci"].astype(np.int64)
    p["ml_loci"] = np.where(ml >= 0, ml + base, -1)
    return p


def merge_chunks(stage: dict, base: torch.Tensor, lengths: torch.Tensor,
                 max_subs_per100: int, med: int) -> dict:
    """The exact merge of a staging set's K slots; see the module's
    note."""
    K, B = stage["best_mm"].shape
    Kml = stage["ml_mm"].shape[2]
    dev = lengths.device
    if (base.dtype != torch.int64 or tuple(base.shape) != (K,)
            or base.device != dev or lengths.dtype != torch.int32
            or tuple(lengths.shape) != (B,)):
        raise ValueError(f"merge_chunks: base {tuple(base.shape)} "
                         f"{base.dtype}, lengths {tuple(lengths.shape)} "
                         f"{lengths.dtype}; want ({K},) int64 and ({B},) "
                         f"int32 on {dev}")
    if dev.type == "cpu":
        if K == 1:
            return {k: torch.from_numpy(np.array(v)) for k, v in one_chunk(
                {k: stage[k][0].numpy() for k in FIELDS},
                int(base[0])).items()}
        mtm = torch.from_numpy(max_tot_mm(lengths.numpy(), max_subs_per100))
        return merge_chunks_plain({k: stage[k] for k in FIELDS}, base, mtm,
                                  med)
    out = {k: torch.empty((B, Kml) if k in _MULTI else (B,),
                          dtype=DTYPES[k], device=dev) for k in FIELDS}
    out["locus"] = torch.empty(B, dtype=torch.int64, device=dev)
    out["ml_loci"] = torch.empty((B, Kml), dtype=torch.int64, device=dev)
    if B:
        lib = kernels.library()
        with torch.cuda.device(dev):
            err = lib.merge_chunks(
                _slots(stage), _slots(out), base.data_ptr(),
                lengths.contiguous().data_ptr(), K, B, Kml,
                max_subs_per100 / 100.0, int(max_subs_per100 != 0), med,
                stage["counts"][2, 0].data_ptr(), kernels.stream_ptr(dev))
        kernels.check(err, "merge_chunks")
        merge_chunks.launches += 1
    return out


merge_chunks.launches = 0
