"""Share of the traced window in which nothing ran on the device: 1 minus
the union of the device's busy intervals (kernels and copies) over the
window, in %.  Nothing where the trace holds no device activity."""


def read(ctx):
    t = ctx["trace"]
    if t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
