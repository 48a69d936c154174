"""The port's tracing: named spans and counters, live only under
`torch.profiler`.

    from biokanga_tpu_torch.utils.trace import count, counts, span

    with span("engine.upload"):
        ...
    count("engine.rows", len(reads))       # a host int
    count("extend.valid_slots", mask)      # or a tensor, summed
    count("seed.filled_slots", lambda: flat != I32_MAX)   # made if counted

While a profiler records (`torch.autograd._profiler_enabled()`), `span`
opens a `torch.profiler.record_function` range, on the profiler's clock
with the device events of its trace, and `count` adds to a named
counter; a tensor is summed on its device, on the stream it was made on
and without waiting for it, and its sum is added in `counts()`, so that
counts from several streams never race; a function is called then, and
only then, for the int or tensor to count.
Otherwise a span is one shared no-op context and a count does nothing,
not even the sum: each costs one check of the profiler's state.  There
is no setting: an operator turns tracing on by running the program
under `torch.profiler`.

`counts()` returns the counters as ints, waiting for the device there
and only there; `reset_counts()` clears them.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.profiler import record_function

_NOOP = contextlib.nullcontext()
_counts: dict = {}
_pending: dict = {}     # name -> tensor sums not yet added to _counts


def span(name: str):
    """A `record_function` range named `name` while a profiler records,
    else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NOOP


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def count(name: str, n) -> None:
    """Add `n` to counter `name` while a profiler records: a host int, a
    tensor whose elements are summed on its device, or a function called
    only then that gives either."""
    if torch.autograd._profiler_enabled():
        if callable(n):
            n = n()
        if isinstance(n, torch.Tensor):
            _pending.setdefault(name, []).append(n.sum())
        else:
            _counts[name] = _counts.get(name, 0) + n


def counts() -> dict:
    """The counters as ints (waits for the device)."""
    if any(t.is_cuda for sums in _pending.values() for t in sums):
        torch.cuda.synchronize()
    for k, sums in _pending.items():
        _counts[k] = _counts.get(k, 0) + int(torch.stack(sums).sum())
    _pending.clear()
    return {k: int(v) for k, v in _counts.items()}


def reset_counts() -> None:
    _counts.clear()
    _pending.clear()
