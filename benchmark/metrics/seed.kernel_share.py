"""Strand passes of the seed stage that ran its hand-written kernel
(counter `seed.kernel_calls`, counted at each `seed_rows` launch) over
every strand pass of the seed stage (`seed.calls`), in %."""
from ._program import counter_share


def read(ctx):
    return counter_share("seed.kernel_calls", "seed.calls")
