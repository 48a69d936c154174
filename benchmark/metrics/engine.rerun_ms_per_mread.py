"""Host time in the `engine.rerun` spans (the classic rerun of the rows
the fast pass left unresolved, with its upload, fetch and rescue ladder),
in ms a million reads of the traced window.  Nothing where no batch
reran a row."""
from ._program import span_ms_per_mread


def read(ctx):
    return span_ms_per_mread(ctx, "engine.rerun")
