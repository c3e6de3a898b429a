"""The idle share of the idlest card over the traced window, in % (the
straggler of the mesh)."""


def read(ctx):
    t = ctx.trace
    if t is None or len(t.devices) < 2:
        return None
    return max(t.idle_pct(d) for d in t.devices)
