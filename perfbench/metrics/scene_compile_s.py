"""Seconds the program spent compiling scenes in this process
(utils/metrics.totals()["scene.compile"]: scene/compiler.py:compile_scene,
the BVH builds and the pack's copy to the device)."""
from perfbench.core.program_spans import total_seconds


def read(ctx):
    return total_seconds("scene.compile")
