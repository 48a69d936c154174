"""Host time in the `pe.classify` and `pe.rescue` ranges (pair
classification and the orphan rescue), in ms a million reads of the
traced window."""


def read(ctx):
    host = ctx["trace"].host_s
    if "pe.classify" not in host:
        return None
    s = host["pe.classify"] + host.get("pe.rescue", 0.0)
    return s * 1e3 / (ctx["mates"] / 1e6)
