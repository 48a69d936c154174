"""#1 `sort_rows` and #2 `sort2_rows` together: the sum of their least
times over the sum of their device times, in %."""
from ._rooflines import share


def read(ctx):
    return share(ctx, ("sort_rows", "sort2_rows"))
