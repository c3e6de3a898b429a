"""The device's idle share over the traced window, in %: 1 - (union of the
device's activity: kernels, copies, fills) / the window's wall seconds,
mean over the cards used."""
from perfbench.core.readers import mean_idle_pct


def read(ctx):
    return mean_idle_pct(ctx)
