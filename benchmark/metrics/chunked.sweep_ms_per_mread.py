"""Host time in the `chunked.sweep` spans (a block's launches, classic
reruns and finishes over every chunk of the chunked index), in ms a
million reads of the traced window."""
from ._program import span_ms_per_mread


def read(ctx):
    return span_ms_per_mread(ctx, "chunked.sweep")
