"""Peak device memory allocated during the traced window (the peak reset
at its start), in GiB."""


def read(ctx):
    b = ctx["peak_bytes"]
    return b / 2**30 if b > 0 else None
