"""Host time in the `pe.rescue` spans of the chunked path (a block's
orphan rescue, on the engines of the anchors' chunks; opened every
block), in ms a million reads of the traced window.  Nothing where the
span is absent."""
from ._program import span_ms_per_mread


def read(ctx):
    return span_ms_per_mread(ctx, "pe.rescue")
