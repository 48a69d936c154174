"""Inputs of the resident chunked path's select and merge
(ops/chunk_merge.py): seeded pass results as the engine gives them, and
per-chunk results whose keys tie across chunks or whose loci pass 2^31.
Numpy, torch and the port's ops/chunk_merge.py only, no jax:
tests/test_torch_chunk_merge.py and chip_smoke.py (phase 32) use it.
"""
import numpy as np
import torch

from biokanga_tpu_torch.ops import chunk_merge as cm

# GRCh38's cell: a chunk's padded length, 2 x 65,536 mates a block, 13
# chunks
CHUNK_LEN = 237_561_344
GRCH38_B = 131_072
GRCH38_K = 13


def pass_result(rng, B, Kml=5, loci=5_000):
    """A pass's host result as the engine gives it: bests around the fast
    pass's bound, rows with no valid candidate (255), skipped cores, cap
    truncation, multi-hit lists with -1 tails, few distinct loci so that
    keys tie."""
    best = rng.integers(0, 12, B).astype(np.uint8)
    best[rng.random(B) < 0.1] = 255
    ml_mm = rng.integers(0, 6, (B, Kml)).astype(np.uint8)
    ml_mm[rng.random((B, Kml)) < 0.3] = 255
    ml_mm.sort(axis=1)
    return {
        "unique": rng.random(B) < 0.5, "any_hit": rng.random(B) < 0.7,
        "best_mm": best,
        "next_mm": np.minimum(best.astype(np.int32)
                              + rng.integers(0, 3, B), 255).astype(np.uint8),
        "inst": rng.integers(0, 4, B).astype(np.int32),
        "locus": rng.integers(0, loci, B).astype(np.int32),
        "is_rc": rng.random(B) < 0.5,
        "ml_loci": np.where(ml_mm < 255, rng.integers(0, loci, (B, Kml)),
                            -1).astype(np.int32),
        "ml_mm": ml_mm,
        "ml_rc": (rng.random((B, Kml)) < 0.5) & (ml_mm < 255),
        "overflow": rng.random(B) < 0.2,
        "n_over": np.where(rng.random(B) < 0.2, rng.integers(1, 3, B),
                           0).astype(np.int32),
        "cap_trunc": rng.random(B) < 0.05,
    }


def tensors(d, device="cpu"):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in d.items()}


def partials(rng, K, B, where):
    """(per-chunk results, chunk bases) for the merge: with "overlap"
    every chunk's loci land on the same global range, so (mm, strand,
    locus) keys and multi-hit keys tie across chunks; with "past_2_31"
    the bases pass 2^31."""
    parts = [pass_result(rng, B) for _ in range(K)]
    for p in parts:
        p["best_mm"][:20] = 255              # no valid candidate anywhere
        p["next_mm"][:20] = 255
        p["best_mm"][20:40] = 1              # one best in several chunks
        p["inst"][20:40] = rng.integers(1, 3, 20)
    if where == "overlap":
        bases = np.arange(K, dtype=np.int64) * 200
        for k, p in enumerate(parts):        # equal global keys
            p["locus"][40:60] = 3_000 - bases[k]
            p["best_mm"][40:60] = 2
            p["is_rc"][40:60] = False
            p["ml_loci"][40:60, 0] = 3_000 - bases[k]
            p["ml_mm"][40:60, 0] = 0
            p["ml_rc"][40:60, 0] = False
    else:
        bases = np.arange(K, dtype=np.int64) * 2_400_000_000 + 17
    return parts, bases


def stage_of(parts, device="cpu"):
    """A staging set holding the per-chunk results `parts`."""
    K, (B, Kml) = len(parts), parts[0]["ml_mm"].shape
    stage = cm.staging(K, B, Kml, device)
    for k, p in enumerate(parts):
        for f in cm.FIELDS:
            stage[f][k] = torch.from_numpy(p[f])
    return stage


def grch38_passes(rng, device):
    """A 13-chunk block's (fast, classic) passes at GRCh38's shapes; each
    locus a column of a wider tensor, as the accept stage leaves it, and
    each multi-hit locus list strided across its columns, which the
    wrapper copies."""
    out = []
    for _ in range(GRCH38_K):
        pair = []
        for _ in range(2):
            p = tensors(pass_result(rng, GRCH38_B, loci=CHUNK_LEN), device)
            wide = torch.zeros((GRCH38_B, 3), dtype=torch.int32,
                               device=device)
            wide[:, 1] = p["locus"]
            p["locus"] = wide[:, 1]
            ml = torch.zeros((GRCH38_B, p["ml_loci"].shape[1], 2),
                             dtype=torch.int32, device=device)
            ml[..., 1] = p["ml_loci"]
            p["ml_loci"] = ml[..., 1]
            pair.append(p)
        out.append(pair)
    return out
