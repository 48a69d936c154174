"""#3 `hamming_extend_packed`: its least time over its device time, in %."""
from ._rooflines import share


def read(ctx):
    return share(ctx, ("extend",))
