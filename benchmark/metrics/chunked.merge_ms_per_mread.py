"""Host time in the `chunked.merge` spans (the exact merge of every
chunk's result into one, on the host), in ms a million reads of the
traced window."""
from ._program import span_ms_per_mread


def read(ctx):
    return span_ms_per_mread(ctx, "chunked.merge")
