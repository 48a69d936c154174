"""Blocks whose merge on the card stood, with no rescue-ladder fallback
on the host (counter `chunked.device_merges`), over the blocks merged
(`chunked.merges`), in %."""
from ._program import counter_share


def read(ctx):
    return counter_share("chunked.device_merges", "chunked.merges")
