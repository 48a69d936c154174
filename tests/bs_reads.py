"""Simulated bisulfite reads, made with numpy from a seed: the simulator
of tests/test_bisulfite.py (`_bs_reads`) for the port's tests and
chip_smoke.py, over the port's numpy-only `seq.encode`.  Imports neither
jax nor the JAX package.

Half the reads come from the top strand and half from the bottom (the
reverse complement of the window), alternating; on each read every C
turns to T with probability `conv_rate` (unmethylated-C conversion).
The draws are made for the whole set at once, so a set of 262,144 reads
takes well under a second.
"""
import numpy as np

from biokanga_tpu_torch.seq.encode import revcomp


def bs_reads(genome: np.ndarray, n: int, read_len: int,
             rng: np.random.Generator, conv_rate: float = 0.98):
    """(names, reads (n, read_len) int8, starts (n,), bottom (n,) bool)."""
    starts = rng.integers(0, len(genome) - read_len, n)
    reads = genome[starts[:, None] + np.arange(read_len)]
    bottom = np.arange(n) % 2 == 1
    reads[bottom] = revcomp(reads[bottom])
    flip = (reads == 1) & (rng.random(reads.shape) < conv_rate)
    reads[flip] = 3                                  # C -> T
    names = [f"bs{i}" for i in range(n)]
    return names, reads.astype(np.int8), starts, bottom
