"""Launches of the align engine that replay captured CUDA graphs (counter
`engine.graph_launches`) over all its launches (`engine.launches`), in
%."""
from ._program import counter_share


def read(ctx):
    return counter_share("engine.graph_launches", "engine.launches")
