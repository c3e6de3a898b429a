"""Steps replayed as CUDA graphs: the port's counterpart of the reference's
compiled and donated step, `jax.jit(step, donate_argnums=(1,))`
(rust_raytracer_tpu/render/pool.py:279 and :292, and the batch trace's
jitted bounce loop, render/renderer.py:77).

Eagerly, a pool step or a batch bounce is ~1,700 kernel launches from
Python, and the host, not the card, sets its time.  `GraphedStep` captures
one call of a step function into a `torch.cuda.CUDAGraph` and replays it:
one launch a step.  The five traversal kernels run inside the graph as
they run eagerly (ops/_cuda.py launches on the current stream, which is
the capturing stream during a capture).

What a capture needs of the step (tests/test_torch_graph.py checks it on
the CPU): no read of the device back (`.item()`, `bool(t)`, `nonzero`,
masked indexing) and no tensor built from host memory (`torch.tensor` of
Python data is a pageable host-to-device copy, which a capturing stream
refuses).  Constants a step builds lazily (the camera's) are built by the
warm-up call that precedes every capture.

The graph runs only where it can: a CUDA device and a walk that launches a
traversal kernel (`applies`).  The "jnp" walk (torch ops that read the
device back, the f64 validation walk) and the CPU run eagerly; so does a
step under metrics.debug_nans, whose check reads the outputs back.  A
capture or replay that fails raises; nothing carries on eagerly.
"""
from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..ops import bvh8, threaded
from ..ops import intersect as isect
from ..ops import wavefront as wf
from ..utils import metrics as metricsmod


def applies(device, kernel: str, pack) -> bool:
    """Whether a step of `pack` on `device` through the walk `kernel`
    replays a graph: on a CUDA device, unless the walk is "jnp"."""
    return (torch.device(device).type == "cuda"
            and isect.resolve_kernel(kernel, pack) != "jnp")


def launch_counts() -> Dict[str, int]:
    """The traversal wrappers' launch counters (ops/bvh8.py, ops/threaded.py,
    ops/wavefront.py), by kernel name."""
    return {"bvh8_traverse": bvh8.launches, "threaded_traverse": threaded.launches,
            **wf.launches}


def _set_launches(counts: Dict[str, int]) -> None:
    bvh8.launches = counts["bvh8_traverse"]
    threaded.launches = counts["threaded_traverse"]
    wf.launches.update({k: counts[k] for k in wf.KERNELS})


def cuda_capture(body: Callable[[], None], device) -> torch.cuda.CUDAGraph:
    """Capture `body` into a CUDA graph on `device` (its own memory pool),
    instantiated, with the raw graph kept for reading its nodes."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.device(device), torch.cuda.graph(graph):
        body()
    graph.instantiate()
    return graph


class Capture(NamedTuple):
    """One captured call: the pack and state layout it was captured for,
    its static state buffers, the graph (anything with `replay()`), the
    launches of one call by kernel, and the seconds the warm-up and capture
    took."""
    pack: object
    key: tuple
    inputs: tuple
    graph: object
    launched: Dict[str, int]
    seconds: float


def _same_pack(a, b) -> bool:
    """Whether two scene packs hold the same tensors (the graph reads their
    addresses) and the same host-side values.  A pack rebuilt around the
    same tensors (pack.to(its own device)) is the same; ScenePack.with_grad
    or a replica on another device is not."""
    if a is b:
        return True
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            if len(x) != len(y) or not all(
                    u is v if isinstance(u, torch.Tensor) else u == v for u, v in zip(x, y)):
                return False
        elif not (x is y if isinstance(x, torch.Tensor) else x == y):
            return False
    return True


class GraphedStep:
    """`step(pack, state) -> state` of `fn`, replayed as a CUDA graph.

    `fn(pack, state)` is a pure function of a scene pack and a NamedTuple
    of tensors that returns the next state of the same layout.  The graph
    reads the state from static buffers and writes the next state back
    into them, standing in for the reference's donated state: a replay
    chains onto the last one.  The step returns clones of the buffers, so
    a returned state stays valid after later calls; a state other than the
    one it last returned (or one changed in place since) is copied into the
    buffers first, so two chains stepped in turn get what the eager step
    gives them.

    One capture per device and state layout, for the last pack seen there:
    another pack (ScenePack.with_grad, a replica on another device, a new
    scene) is captured anew, never replayed through a stale graph.  A
    capture is preceded by one eager warm-up call on a side stream, as
    torch.cuda.graphs requires; it builds the kernel library and lazily
    built constants, and counts the launches one call makes.  Neither the
    warm-up nor the capture moves the launch counters (`launch_counts`);
    each replay advances them by the warm-up's count.  Under
    metrics.debug_nans the step runs `fn` eagerly.

    `capture(body, device)` returns the graph of `body` (default
    `cuda_capture`); a test may stand in for it.
    """

    def __init__(self, fn: Callable, capture: Optional[Callable] = None):
        self.fn = fn
        self._capture = capture
        self.captures: Dict[torch.device, Capture] = {}
        self._last = ()

    def __call__(self, pack, state):
        if metricsmod.nan_checks():
            return self.fn(pack, state)
        dev = state[0].device
        key = tuple((t.shape, t.dtype) for t in state)
        cap = self.captures.get(dev)
        if cap is None or cap.key != key or not _same_pack(cap.pack, pack):
            cap = self.captures[dev] = None   # free the old graph first
            cap = self.captures[dev] = self._record(pack, state, key)
        elif not self._holds(state):
            for buf, t in zip(cap.inputs, state):
                buf.copy_(t)
        counts = launch_counts()
        cap.graph.replay()
        _set_launches({k: n + cap.launched.get(k, 0) for k, n in counts.items()})
        out = type(state)(*(buf.clone() for buf in cap.inputs))
        self._last = tuple((weakref.ref(t), t._version) for t in out)
        return out

    def _holds(self, state) -> bool:
        """Whether `state` is the one last returned, unchanged: its values
        are then in the buffers already."""
        return len(self._last) == len(state) and all(
            ref() is t and t._version == v for (ref, v), t in zip(self._last, state))

    def _record(self, pack, state, key) -> Capture:
        t0 = time.perf_counter()
        dev = state[0].device
        inputs = type(state)(*(t.clone() for t in state))

        def body():
            out = self.fn(pack, inputs)
            for buf, t in zip(inputs, out):
                buf.copy_(t)

        counts = launch_counts()
        try:
            with torch.no_grad():
                if dev.type == "cuda":
                    side = torch.cuda.Stream(dev)
                    side.wait_stream(torch.cuda.current_stream(dev))
                    with torch.cuda.stream(side):
                        self.fn(pack, inputs)
                    torch.cuda.current_stream(dev).wait_stream(side)
                else:
                    self.fn(pack, inputs)
                after = launch_counts()
                graph = (self._capture or cuda_capture)(body, dev)
        finally:
            _set_launches(counts)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._last = ()
        launched = {k: after[k] - counts[k] for k in counts if after[k] != counts[k]}
        return Capture(pack, key, inputs, graph, launched, time.perf_counter() - t0)


def cached(cache: dict, pins: tuple, values: tuple, build: Callable):
    """cache's entry for (the objects `pins`, by identity, and the hashable
    `values`), made by `build()` at first use.  The pins are kept beside
    the entry, so their ids are not reused while it lives."""
    key = tuple(id(p) for p in pins) + values
    if key not in cache:
        cache[key] = (pins, build())
    return cache[key][1]
