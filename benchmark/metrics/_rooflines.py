"""Share of a kernel group's roofline: the sum of its calls' least times
(benchmark/roofline.py, counted on a replay of the traced batches) over
its kernels' device time in the trace, in %.  Nothing where the trace
holds none of its kernels or the replay made another number of calls."""


def share(ctx, groups):
    trace, counts = ctx["trace"], ctx["counts"]
    device_s = bound = 0.0
    for g in groups:
        calls = trace.host_calls.get("bench.kernel." + g, 0)
        if g not in counts or counts[g]["calls"] != calls:
            return None
        device_s += trace.group_s.get(g, 0.0)
        bound += counts[g]["bound_s"]
    if device_s <= 0:
        return None
    return 100.0 * bound / device_s
