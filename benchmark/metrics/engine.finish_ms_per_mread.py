"""Host time in the `pe.finish` ranges (the wait for the device, the
fetch, the classic rerun and the rescue ladder), in ms a million reads of
the traced window."""


def read(ctx):
    s = ctx["trace"].host_s.get("pe.finish")
    return None if s is None else s * 1e3 / (ctx["mates"] / 1e6)
