"""Inputs of the chromatin tools at the field's standard size (numpy and
the port's numpy-only modules, no jax: chip_smoke.py imports it too).

- YEAST_R64: the 16 nuclear chromosomes of S. cerevisiae R64 and their
  lengths (12.07 Mbp), the standard genome of MNase-seq; `yeast_genome`
  gives seeded random sequence of that layout.
- `write_octamer_table`: a seeded octamer structural-parameter table in
  the reference CSV layout (a header, then an octamer and its 22 values
  a row; every octamer, or a seeded subset).
- `cores`: sequences of NUC_CORE bases drawn from a genome, as a FASTA
  of nucleosome cores for `genstructprofile`.
"""
import numpy as np

from biokanga_tpu_torch.chromatin.conformation import (N_OCT,
                                                       OCT_PARAM_NAMES,
                                                       idx_to_oligo)
from biokanga_tpu_torch.chromatin.nucleosomes import NUC_CORE
from biokanga_tpu_torch.sim.simreads import random_genome

YEAST_R64 = [("I", 230_218), ("II", 813_184), ("III", 316_620),
             ("IV", 1_531_933), ("V", 576_874), ("VI", 270_161),
             ("VII", 1_090_940), ("VIII", 562_643), ("IX", 439_888),
             ("X", 745_751), ("XI", 666_816), ("XII", 1_078_177),
             ("XIII", 924_431), ("XIV", 784_333), ("XV", 1_091_291),
             ("XVI", 948_066)]


def yeast_genome(seed: int) -> list[tuple[str, np.ndarray]]:
    return random_genome(YEAST_R64, seed=seed)


def write_octamer_table(path, seed: int, n_rows: int = N_OCT) -> None:
    """n_rows octamers (all of them by default, else a seeded subset),
    each with 22 seeded values printed to 4 decimals."""
    rng = np.random.default_rng(seed)
    rows = (np.arange(N_OCT) if n_rows == N_OCT
            else np.sort(rng.choice(N_OCT, n_rows, replace=False)))
    vals = rng.uniform(-5.0, 40.0, (rows.size, len(OCT_PARAM_NAMES)))
    with open(path, "w") as f:
        f.write("octamer," + ",".join(OCT_PARAM_NAMES) + "\n")
        for i, v in zip(rows.tolist(), vals.tolist()):
            f.write(idx_to_oligo(i, 8) + ","
                    + ",".join(f"{x:.4f}" for x in v) + "\n")


def cores(genome, n: int, seed: int) -> list[tuple[str, np.ndarray]]:
    """n (name, codes) records of NUC_CORE bases at seeded loci."""
    rng = np.random.default_rng(seed)
    which = rng.integers(0, len(genome), n)
    out = []
    for i, c in enumerate(which.tolist()):
        name, codes = genome[c]
        s = int(rng.integers(0, codes.size - NUC_CORE))
        out.append((f"core{i}|{name}|{s}", codes[s: s + NUC_CORE]))
    return out
