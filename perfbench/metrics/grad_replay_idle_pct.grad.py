"""The card's idle share of the traced window, in %, while the host is in
the fwd+bwd step's replay (the program's span `rrt.grad.replay`: the
lanes' copy-in, the graph launch, the outputs' clones)."""
from perfbench.core.program_spans import idle_under_pct


def read(ctx):
    return idle_under_pct(ctx.trace, "grad.replay")
