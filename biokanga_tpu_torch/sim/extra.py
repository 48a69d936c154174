"""Copy of biokanga_tpu/sim/extra.py: RNA fragment simulation, DE-count
simulation, and the k-let-preserving genome randomiser.

Parity roles (SURVEY §2.6 expression/simulation group):
- RNAFragSim/ (1,052 LoC): simulate RNA-seq fragments from transcripts.
- usimdiffexpr/ (1,107 LoC): simulate differential-expression count
  tables with controlled fold changes.
- kangarg/ (750 LoC) + CShuffle (libbiokanga/Shuffle.cpp, composition-
  preserving sequence shuffling): genome K-mer randomiser.
"""
from __future__ import annotations

import numpy as np

from ..seq.annotations import read_bed
from ..seq.encode import revcomp


def rna_frag_sim(
    seqs: list[tuple[str, np.ndarray]],
    bed_path: str,
    n_frags: int,
    frag_min: int = 150,
    frag_max: int = 400,
    read_len: int = 100,
    seed: int = 1,
    expr_alpha: float = 1.0,
):
    """Simulate RNA-seq fragments from transcript features.

    Transcript abundances are drawn from a Dirichlet (power-law-ish when
    alpha<1); each fragment picks a transcript, a start uniform within it,
    and a length uniform in [frag_min, frag_max]; the 5' read_len bases
    (sense strand of the feature) become the read.  Returns
    (names, reads list[int8], per-transcript true counts).
    """
    rng = np.random.default_rng(seed)
    feats = read_bed(bed_path)
    by_name = {name: codes for name, codes in seqs}
    feats = [f for f in feats if f.chrom in by_name
             and f.end - f.start >= frag_min]
    if not feats:
        raise ValueError("no usable transcript features")
    probs = rng.dirichlet(np.full(len(feats), expr_alpha))
    tidx = rng.choice(len(feats), size=n_frags, p=probs)
    true_counts = np.bincount(tidx, minlength=len(feats))
    names, reads = [], []
    for i, t in enumerate(tidx):
        f = feats[t]
        tlen = f.end - f.start
        flen = int(rng.integers(frag_min, min(frag_max, tlen) + 1))
        s = int(rng.integers(0, tlen - flen + 1))
        frag = by_name[f.chrom][f.start + s: f.start + s + flen]
        if f.strand == "-":
            frag = revcomp(frag)
        reads.append(frag[:read_len].astype(np.int8))
        names.append(f"lcl|rnafragsim|{i + 1:08d}|{f.name}|{f.chrom}"
                     f"|{f.start + s}|{flen}|{f.strand}")
    return names, reads, [(f.name, int(c))
                          for f, c in zip(feats, true_counts)]


def sim_diff_expr(
    n_features: int,
    n_ctrl: int = 3,
    n_expt: int = 3,
    de_frac: float = 0.1,
    fold_change: float = 4.0,
    mean_count: float = 200.0,
    dispersion: float = 0.2,
    seed: int = 1,
):
    """Simulate a DE count table (usimdiffexpr role).

    Counts ~ negative binomial around a per-feature baseline; a de_frac
    subset of features gets `fold_change` applied (half up, half down) in
    the experiment replicates.  Returns (feature names, ctrl (F,n_ctrl),
    expt (F,n_expt), truth array of per-feature fold changes).
    """
    rng = np.random.default_rng(seed)
    base = rng.lognormal(np.log(mean_count), 1.0, n_features)
    truth = np.ones(n_features)
    n_de = int(round(n_features * de_frac))
    de_ids = rng.choice(n_features, size=n_de, replace=False)
    up = de_ids[: n_de // 2]
    down = de_ids[n_de // 2:]
    truth[up] = fold_change
    truth[down] = 1.0 / fold_change

    def nb(mu):
        # NB via gamma-poisson; r = 1/dispersion
        r = 1.0 / max(dispersion, 1e-9)
        lam = rng.gamma(r, mu / r)
        return rng.poisson(lam)

    ctrl = np.stack([nb(base) for _ in range(n_ctrl)], axis=1)
    expt = np.stack([nb(base * truth) for _ in range(n_expt)], axis=1)
    names = [f"feat{i + 1}" for i in range(n_features)]
    return names, ctrl, expt, truth


def klet_shuffle(codes: np.ndarray, k: int = 2, seed: int = 1) -> np.ndarray:
    """Shuffle a sequence preserving exact (k-1)-order composition —
    every k-mer count is conserved (Altschul–Erikson doublet shuffle,
    generalised to k via de Bruijn multigraph Euler paths).

    k=1 degenerates to a plain permutation.  N bases participate as a
    fifth symbol so N-runs are conserved in count too.
    """
    rng = np.random.default_rng(seed)
    c = np.asarray(codes, np.int8)
    n = len(c)
    if k <= 1 or n <= k:
        out = c.copy()
        rng.shuffle(out)
        return out
    # vertices: (k-1)-mers as tuples; edges: successive overlaps
    verts = [tuple(c[i: i + k - 1]) for i in range(n - k + 2)]
    edges: dict[tuple, list[tuple]] = {}
    for a, b in zip(verts[:-1], verts[1:]):
        edges.setdefault(a, []).append(b)
    start, end = verts[0], verts[-1]
    # Wilson-ish: build a random arborescence toward `end` by picking a
    # random LAST exit edge per vertex that leads to `end`, then shuffle
    # the rest — the classic A-E condition for a valid Euler path.
    last_exit: dict[tuple, tuple] = {}
    for v in edges:
        if v == end:
            continue
        # random walk from v to end over edge graph to pick a reachable exit
        # (graph is connected through the original path, so BFS tree works)
        last_exit[v] = None  # placeholder
    # BFS from end over REVERSED edges to get a tree of exits toward end
    radj: dict[tuple, list[tuple]] = {}
    for a, outs in edges.items():
        for b in outs:
            radj.setdefault(b, []).append(a)
    order = [end]
    seen = {end}
    qi = 0
    while qi < len(order):
        v = order[qi]
        qi += 1
        for u in rng.permutation(len(radj.get(v, []))):
            u = radj[v][u]
            if u not in seen:
                seen.add(u)
                last_exit[u] = v
                order.append(u)
    for v, outs in edges.items():
        outs_arr = list(outs)
        rng.shuffle(outs_arr)
        if v != end and last_exit.get(v) is not None:
            # move one copy of the chosen exit to the back
            outs_arr.remove(last_exit[v])
            outs_arr.append(last_exit[v])
        edges[v] = outs_arr
    # walk the Euler path
    ptr = {v: 0 for v in edges}
    out = list(start)
    v = start
    for _ in range(len(verts) - 1):
        nxt = edges[v][ptr[v]]
        ptr[v] += 1
        out.append(nxt[-1])
        v = nxt
    return np.asarray(out, np.int8)
