"""Spans the benchmark records around the calls into each of the program's
layers, in traced runs only: each listed callable is wrapped, for the
traced window, in a torch.profiler.record_function named "perfbench.<layer
span>", so the device trace can say what the host was doing in a gap (a
poll, a capture, the image's copy home).  Nothing inside the program is
changed; the wrappers are removed when the window's trace ends."""
from __future__ import annotations

import contextlib
import functools
import importlib

import torch

# (module, attribute or Class.method, span name)
SPANS = (
    ("rust_raytracer_torch.render.pool", "make_step", "pool.make_step"),
    ("rust_raytracer_torch.render.pool", "host_sums", "pool.poll"),
    ("rust_raytracer_torch.render.pool", "shard_sums", "pool.poll"),
    ("rust_raytracer_torch.render.pool", "sum_planes", "mesh.join"),
    ("rust_raytracer_torch.render.pool", "init_state", "pool.init"),
    ("rust_raytracer_torch.render.pool", "init_shards", "pool.init"),
    ("rust_raytracer_torch.render.graphs", "GraphedStep._record", "graphs.capture"),
    ("rust_raytracer_torch.render.graphs", "GraphedGrad._record", "graphs.capture"),
    ("rust_raytracer_torch.render.graphs", "GraphedStep.__call__", "graphs.step"),
    ("rust_raytracer_torch.render.film", "Film.add_samples", "film.to_host"),
    ("rust_raytracer_torch.ops.vertex", "prepare", "vertex.prepare"),
)


def _wrap(fn, name):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with torch.profiler.record_function("perfbench." + name):
            return fn(*args, **kwargs)
    return spanned


@contextlib.contextmanager
def layer_spans():
    """SPANS wrapped in their spans while the block runs."""
    undo = []
    try:
        for module, attr, name in SPANS:
            owner = importlib.import_module(module)
            *cls, leaf = attr.split(".")
            for c in cls:
                owner = getattr(owner, c)
            orig = owner.__dict__[leaf] if cls else getattr(owner, leaf)
            setattr(owner, leaf, _wrap(orig, name))
            undo.append((owner, leaf, orig))
        yield
    finally:
        for owner, leaf, orig in reversed(undo):
            setattr(owner, leaf, orig)
