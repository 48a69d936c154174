"""Host time in the `pe.launch` ranges (the engine's upload and enqueue of
a fused batch), in ms a million reads of the traced window."""


def read(ctx):
    s = ctx["trace"].host_s.get("pe.launch")
    return None if s is None else s * 1e3 / (ctx["mates"] / 1e6)
