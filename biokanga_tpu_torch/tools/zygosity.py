"""Copy of biokanga_tpu/tools/zygosity.py (host numpy).

Zygosity and bootstrap tools.

- genzygosity: chromosome-vs-chromosome K-mer sharing score matrix
  (capability match for genzygosity/ — CGenZygosity, suffix-array
  K-mer walk). Implemented as a single pass over the sorted SA:
  each distinct K-mer is a contiguous run; a run present in entries
  {A, B, ...} contributes its per-entry position counts to every
  (present-entry, present-entry) cell.
- alignsbs: alignment bootstrapper (capability match for
  CAlignsBootstrap, biokanga/AlignsBootstrap.cpp) — resampled
  per-feature count differences between two alignment sets with
  empirical p-values.
"""
from __future__ import annotations

import numpy as np

from ..index.build import GenomeIndex


def zygosity_matrix(idx: GenomeIndex, K: int = 20):
    """(E, E) matrix: M[a, b] = fraction of entry a's K-mer positions
    whose K-mer also occurs in entry b (M[a, a] == 1)."""
    K_eff = min(K, 32)
    n = idx.total_len
    E = len(idx.entry_names)

    if K_eff >= 16:
        hi = idx.key_hi
        lo = (idx.key_lo >> np.uint32(2 * (32 - K_eff))) if K_eff < 32 \
            else idx.key_lo
    else:
        hi = idx.key_hi >> np.uint32(2 * (16 - K_eff))
        lo = np.zeros_like(idx.key_lo)

    pos = idx.pos_sorted.astype(np.int64)
    ent = np.searchsorted(idx.entry_starts, pos, side="right") - 1
    fits = pos + K_eff <= idx.entry_starts[ent + 1]

    boundary = np.ones(n, dtype=bool)
    boundary[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    seg = np.cumsum(boundary) - 1
    n_seg = int(seg[-1]) + 1

    counts = np.zeros((n_seg, E), dtype=np.int64)
    np.add.at(counts, (seg[fits], ent[fits]), 1)
    present = counts > 0

    shared = np.zeros((E, E), dtype=np.int64)  # positions of a whose kmer in b
    for b in range(E):
        mask = present[:, b]
        shared[:, b] = counts[mask].sum(axis=0)
    totals = counts.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        M = shared / np.maximum(totals[:, None], 1)
    return M, totals


def write_zygosity_csv(path: str, names, M):
    with open(path, "w") as f:
        f.write('"Entry",' + ",".join(f'"{n}"' for n in names) + "\n")
        for i, n in enumerate(names):
            f.write(f'"{n}",' + ",".join(f"{v:.4f}" for v in M[i]) + "\n")


def aligns_bootstrap(
    counts_a: np.ndarray,     # per-feature counts, set A
    counts_b: np.ndarray,     # per-feature counts, set B
    iterations: int = 1000,
    seed: int = 1,
    with_replacement: bool = True,
):
    """Empirical p-values for per-feature count differences: pooled-null
    resampling of the two libraries (CAlignsBootstrap role; the reference
    caps confidence iterations at 10000, kangade.cpp:65)."""
    iterations = min(iterations, 10000)
    rng = np.random.default_rng(seed)
    na, nb = int(counts_a.sum()), int(counts_b.sum())
    F = len(counts_a)
    pooled = counts_a + counts_b
    p_feat = pooled / max(pooled.sum(), 1)
    obs = counts_a / max(na, 1) - counts_b / max(nb, 1)
    extreme = np.zeros(F, dtype=np.int64)
    for _ in range(iterations):
        if with_replacement:
            sa = rng.multinomial(na, p_feat)
            sb = rng.multinomial(nb, p_feat)
        else:
            pool = np.repeat(np.arange(F), pooled.astype(np.int64))
            rng.shuffle(pool)
            sa = np.bincount(pool[:na], minlength=F)
            sb = np.bincount(pool[na : na + nb], minlength=F)
        sim = sa / max(na, 1) - sb / max(nb, 1)
        extreme += np.abs(sim) >= np.abs(obs)
    pvals = (extreme + 1) / (iterations + 1)
    return obs, pvals
