"""Host time in the `engine.fetch` spans (the primary pass's result
brought to the host in `AlignEngine.finish_primary`: the wait for the
device and the copy), in ms a million reads of the traced window."""
from ._program import span_ms_per_mread


def read(ctx):
    return span_ms_per_mread(ctx, "engine.fetch")
