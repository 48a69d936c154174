"""Host time in the `engine.enqueue` spans (the `align_core` call of
`AlignEngine.launch`: the host's enqueue of the device stages, the classic
rerun's and the ladder's included), in ms a million reads of the traced
window."""
from ._program import span_ms_per_mread


def read(ctx):
    return span_ms_per_mread(ctx, "engine.enqueue")
