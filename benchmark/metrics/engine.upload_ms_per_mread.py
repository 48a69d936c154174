"""Host time in the `engine.upload` spans (the copy of each batch's reads
and lengths to the device in `AlignEngine.launch`, the classic rerun's
and the ladder's included), in ms a million reads of the traced window."""
from ._program import span_ms_per_mread


def read(ctx):
    return span_ms_per_mread(ctx, "engine.upload")
