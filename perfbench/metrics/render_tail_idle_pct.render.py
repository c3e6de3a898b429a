"""The cards' idle share of the traced window, in %, while the host is in
a render's tail (the program's span `rrt.render.tail`: the shards' planes
joined, the image's copy home and its float64 add into the Film): mean
over the cards."""
from perfbench.core.program_spans import idle_under_pct


def read(ctx):
    return idle_under_pct(ctx.trace, "render.tail")
