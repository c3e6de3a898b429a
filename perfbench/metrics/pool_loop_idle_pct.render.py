"""The cards' idle share of the traced window, in %, while the host is in
the pool loop (the program's span `rrt.pool.loop`: the steps' replays and
the polls' reads): mean over the cards."""
from perfbench.core.program_spans import idle_under_pct


def read(ctx):
    return idle_under_pct(ctx.trace, "pool.loop")
