"""Rows the fast pass left unresolved, which the classic pass reruns
(counter `engine.rerun_rows`), over the rows the primary pass aligned
(`engine.rows`), in %."""
from ._program import counter_share


def read(ctx):
    return counter_share("engine.rerun_rows", "engine.rows")
