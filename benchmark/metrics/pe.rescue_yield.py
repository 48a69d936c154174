"""Mates the orphan rescue places (counter `pe.rescued_mates`) over the
mates sent to it (`pe.rescue_mates`), in %."""
from ._program import counter_share


def read(ctx):
    return counter_share("pe.rescued_mates", "pe.rescue_mates")
