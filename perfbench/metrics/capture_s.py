"""Seconds the program spent warming up and capturing its CUDA graphs in
this process, set-up included (utils/metrics.totals()["graphs.capture"]:
each GraphedStep, GraphedGrad and LoopGraph capture, ending in a
synchronize)."""
from perfbench.core.program_spans import total_seconds


def read(ctx):
    return total_seconds("graphs.capture")
