"""Copy of biokanga_tpu/sim/repeatgenome.py: realistic-repeat genome
simulation.

Every earlier bench genome was uniform random (unique_frac 1.0); real
genomes are ~half repeats, which is exactly what the reference's
over-occurring-seed machinery exists for (MaxIter=50000
libbiokanga/SfxArrayV2.h:12, InitOverOccKMers).  This generator builds a
genome with the repeat classes that matter for seed statistics:

  - GC-skewed backbone: base composition drifts in ~100 kb isochore
    blocks (GC 0.35-0.58 random walk), so k-mer frequencies are
    non-uniform even outside repeats
  - LINE-like family: ~6 kb consensus, dispersed copies, 5' truncation
    (most real LINE copies are truncated), 2-15 % per-copy divergence
  - SINE-like family: ~300 bp consensus, high copy number
  - LTR-like family: ~800 bp
  - satellite blocks: tandem arrays of a ~171 bp monomer (alpha-like),
    megabase-scale runs with per-monomer divergence

Copies overwrite the backbone at random non-reserved positions; the
returned stats record realised repeat fractions per class.
"""
from __future__ import annotations

import numpy as np


def _diverge(rng: np.random.Generator, seq: np.ndarray,
             rate: float) -> np.ndarray:
    out = seq.copy()
    m = rng.random(len(out)) < rate
    out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
    # small indel component: delete/duplicate short stretches
    if rng.random() < 0.5 and len(out) > 40:
        cut = int(rng.integers(1, 12))
        at = int(rng.integers(0, len(out) - cut))
        out = np.delete(out, slice(at, at + cut))
    return out


def _gc_backbone(rng: np.random.Generator, n: int,
                 block: int = 100_000) -> np.ndarray:
    nb = -(-n // block)
    gc = np.empty(nb)
    g = 0.46
    for i in range(nb):
        g = float(np.clip(g + rng.normal(0, 0.03), 0.35, 0.58))
        gc[i] = g
    codes = np.empty(n, np.int8)
    for i in range(nb):
        m = min(block, n - i * block)
        p_gc = gc[i] / 2
        p_at = (1 - gc[i]) / 2
        codes[i * block: i * block + m] = rng.choice(
            4, size=m, p=[p_at, p_gc, p_gc, p_at]).astype(np.int8)
    return codes


def repeat_genome(total_bp: int, seed: int = 0,
                  line_frac: float = 0.18, sine_frac: float = 0.10,
                  ltr_frac: float = 0.05, sat_frac: float = 0.04):
    """Returns (codes int8 (total_bp,), stats dict)."""
    rng = np.random.default_rng(seed)
    codes = _gc_backbone(rng, total_bp)
    placed = {k: 0 for k in ("line", "sine", "ltr", "satellite")}

    line_cons = rng.integers(0, 4, 6_000, np.int8)
    sine_cons = rng.integers(0, 4, 300, np.int8)
    ltr_cons = rng.integers(0, 4, 800, np.int8)
    sat_mono = rng.integers(0, 4, 171, np.int8)

    def place(seq):
        at = int(rng.integers(0, total_bp - len(seq)))
        codes[at: at + len(seq)] = seq
        return len(seq)

    # satellites first (long blocks)
    while placed["satellite"] < sat_frac * total_bp:
        n_mono = int(rng.integers(500, 6000))
        arr = np.concatenate([
            _diverge(rng, sat_mono, float(rng.uniform(0.01, 0.08)))
            for _ in range(n_mono)
        ])
        arr = arr[: min(len(arr), total_bp // 20)]
        placed["satellite"] += place(arr)

    for name, cons, frac in (("line", line_cons, line_frac),
                             ("sine", sine_cons, sine_frac),
                             ("ltr", ltr_cons, ltr_frac)):
        while placed[name] < frac * total_bp:
            c = _diverge(rng, cons, float(rng.uniform(0.02, 0.15)))
            if name == "line" and rng.random() < 0.6:
                c = c[int(rng.integers(0, len(c) * 3 // 4)):]  # 5' trunc
            if rng.random() < 0.5:  # either strand
                c = (3 - c[::-1]).astype(np.int8)
            placed[name] += place(c)

    stats = {k: round(v / total_bp, 4) for k, v in placed.items()}
    stats["repeat_frac_placed"] = round(
        sum(placed.values()) / total_bp, 4)
    return codes, stats
