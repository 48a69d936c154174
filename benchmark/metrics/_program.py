"""Readers of the program's own spans and counters: host time in a span
per million reads of the traced window, and one counter over another.
Counters are those of `biokanga_tpu_torch.utils.trace`, which counts only
while a profiler records, so in a traced run they hold the traced
batches alone.  Nothing where the span, the counter module or the
denominator is absent."""


def span_ms_per_mread(ctx, name):
    s = ctx["trace"].host_s.get(name)
    return None if s is None else s * 1e3 / (ctx["mates"] / 1e6)


def counter_share(num, den):
    try:
        from biokanga_tpu_torch.utils.trace import counts
    except ImportError:
        return None
    c = counts()
    if not c.get(den) or num not in c:
        return None
    return 100.0 * c[num] / c[den]
