"""Steps replayed as CUDA graphs: the port's counterpart of the reference's
compiled steps, the pool step (`jax.jit(step, donate_argnums=(1,))`,
rust_raytracer_tpu/render/pool.py:279 and :292), the gradient step
(`jax.jit(jax.grad(loss))`, bench.py:87; parallel/mesh.py:125's
train_step_fn) and the batch program with its while loop (`LoopGraph`;
`jax.jit(batch_fn)`, render/renderer.py:77).

Eagerly, a pool step or a batch bounce was ~1,700 kernel launches from
Python before its path vertex became the kernels of ops/vertex.py (a few
dozen since), and a fwd+bwd step is ~57,600: the host, not the card, sets
their time.  `GraphedStep` captures one call of a step function into a
`torch.cuda.CUDAGraph` and replays it: one launch a step.  `GraphedGrad`
does the same for a loss's forward and its whole backward pass
(`torch.autograd.grad`), one launch a gradient step.  `LoopGraph` puts a
prologue, a loop body under a conditional WHILE node whose condition a
kernel sets on the card, and an epilogue into one graph: a batch of the
batch render, its bounce loop included, is one launch.  The traversal
kernels and the path vertex kernels (ops/vertex.py, whose scene tables are
built before a capture) run inside the graphs as they run eagerly (ops/_cuda.py launches
on the current stream, which is the capturing stream during a capture,
and the autograd engine runs a backward op, a checkpoint's recompute
included, on its forward op's stream).

What a capture needs of the step (tests/test_torch_graph.py and
tests/test_torch_grad_graph.py check it on the CPU, forward and backward):
no read of the device back (`.item()`, `bool(t)`, `nonzero`, masked
indexing) and no tensor built from host memory (`torch.tensor` of Python
data is a pageable host-to-device copy, which a capturing stream refuses).
Constants a step builds lazily (the camera's, a checkpoint's recompute)
are built by the warm-up call that precedes every capture.

What stays eager: the graph runs only where it can, on a CUDA device and
a walk that launches a traversal kernel (`applies`).  The "jnp" walk
(torch ops that read the device back, the f64 validation walk) and the CPU
run eagerly; so does a step under metrics.debug_nans, whose check reads
the outputs back, and everything while RRT_WF_CHECK asks the wavefront
walk to print its overflow.  Around the graphs, the host still runs the
pool's poll reads (one a device; a pool step is one replay a shard and
nothing else), the batch render's one wait a batch, and train_step_fn's
copies and cross-shard sums.  `integrator.trace`
(non-differentiable, with its one `alive.any()` read a bounce) always runs
eagerly: it is the batch program's plain version.  A capture or replay
that fails raises; nothing carries on eagerly.

On a profiler's trace (utils/metrics.py:span) a GraphedStep's replay is
span `graphs.replay`, a GraphedGrad's `grad.replay` (its unit the replay's
index), and every warm-up and capture, a LoopGraph's build included,
`graphs.capture`, whose count and seconds metrics.totals() keeps.
"""
from __future__ import annotations

import os
import time
import weakref
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..ops import bvh8, gather, loop_cond, threaded, vertex
from ..ops import intersect as isect
from ..ops import wavefront as wf
from ..utils import metrics as metricsmod


def applies(device, kernel: str, pack) -> bool:
    """Whether a step of `pack` on `device` through the walk `kernel`
    replays a graph: on a CUDA device, unless the walk is "jnp" or
    RRT_WF_CHECK is set (its overflow print reads the device each call,
    ops/wavefront.py)."""
    return (torch.device(device).type == "cuda"
            and isect.resolve_kernel(kernel, pack) != "jnp"
            and not os.environ.get("RRT_WF_CHECK"))


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters (ops/bvh8.py, ops/threaded.py,
    ops/wavefront.py, ops/loop_cond.py, ops/vertex.py, ops/gather.py), by
    kernel name."""
    return {"bvh8_traverse": bvh8.launches, "threaded_traverse": threaded.launches,
            **wf.launches, "loop_cond": loop_cond.launches, **vertex.launches,
            **gather.launches}


def _set_launches(counts: Dict[str, int]) -> None:
    bvh8.launches = counts["bvh8_traverse"]
    threaded.launches = counts["threaded_traverse"]
    wf.launches.update({k: counts[k] for k in wf.KERNELS})
    loop_cond.launches = counts["loop_cond"]
    vertex.launches.update({k: counts[k] for k in vertex.KERNELS})
    gather.launches.update({k: counts[k] for k in gather.launches})


def cuda_capture(body: Callable[[], None], device) -> torch.cuda.CUDAGraph:
    """Capture `body` into a CUDA graph on `device` (its own memory pool),
    instantiated, with the raw graph kept for reading its nodes.  The
    capture stream is a new stream of `device`: torch.cuda.graph's default
    is one stream made on the device current at its first use, which on
    another device's capture would leave the body's ops outside it."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.device(device), torch.cuda.graph(graph, stream=torch.cuda.Stream(device)):
        body()
    graph.instantiate()
    return graph


class Capture(NamedTuple):
    """One captured call: the pack and state layout it was captured for,
    its static input buffers, the graph (anything with `replay()`), the
    launches of one call by kernel, the seconds the warm-up and capture
    took, and (GraphedGrad) the list holding the static outputs."""
    pack: object
    key: tuple
    inputs: tuple
    graph: object
    launched: Dict[str, int]
    seconds: float
    outputs: Optional[list] = None


def same_pack(a, b) -> bool:
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
    """`step(pack, state) -> state` of `fn`, replayed as a CUDA graph, with
    its state donated as the reference's jitted step donates it.

    `fn(pack, state)` is a pure function of a scene pack and a NamedTuple
    of tensors that returns the next state of the same layout.  The graph
    reads the state from static buffers and writes the next state back
    into them, and the step returns the buffers themselves: a replay
    chains onto the last one, a step issues the replay and nothing else,
    and the state it returned last is overwritten by its next call.  So a
    step holds one chain.  A state other than the one it returned last is
    copied into the buffers first (that one, changed in place or not, is
    read where it is); a chain that must outlive another chain's steps
    takes a step of its own.

    One capture per device and state layout, for the last pack seen there:
    another pack (ScenePack.with_grad, a replica on another device, a new
    scene) is captured anew, never replayed through a stale graph.  A
    capture is preceded by one eager warm-up call on a side stream, as
    torch.cuda.graphs requires; it builds the kernel library and lazily
    built constants, and counts the launches one call makes.  Neither the
    warm-up nor the capture moves the launch counters (`launch_counts`);
    each replay advances them by the warm-up's count.  `counters` are
    tensors that `fn` adds to in place (its metric counters, read by the
    graph as static buffers): the warm-up's additions to them are taken
    back, so a step is counted once.  Under metrics.debug_nans the step
    runs `fn` eagerly.

    `capture(body, device)` returns the graph of `body` (default
    `cuda_capture`); a test may stand in for it.
    """

    def __init__(self, fn: Callable, capture: Optional[Callable] = None,
                 counters: tuple = ()):
        self.fn = fn
        self._capture = capture
        self.counters = counters
        self.captures: Dict[torch.device, Capture] = {}

    def __call__(self, pack, state):
        if metricsmod.nan_checks():
            return self.fn(pack, state)
        dev = state[0].device
        key = tuple((t.shape, t.dtype) for t in state)
        cap = self.captures.get(dev)
        fresh = cap is None or cap.key != key or not same_pack(cap.pack, pack)
        if fresh:
            cap = self.captures[dev] = None   # free the old graph first
            cap = self.captures[dev] = self._record(pack, state, key)
        with metricsmod.span("graphs.replay"):
            if not fresh and not _holds(cap, state):
                for buf, t in zip(cap.inputs, state):
                    buf.copy_(t)
            counts = launch_counts()
            cap.graph.replay()
            _set_launches({k: n + cap.launched.get(k, 0) for k, n in counts.items()})
        return cap.inputs

    def _record(self, pack, state, key) -> Capture:
        t0 = time.perf_counter()
        dev = state[0].device
        inputs = type(state)(*(t.clone() for t in state))

        def body():
            out = self.fn(pack, inputs)
            for buf, t in zip(inputs, out):
                buf.copy_(t)

        def warm():
            kept = [c.clone() for c in self.counters]
            self.fn(pack, inputs)
            for c, k in zip(self.counters, kept):
                c.copy_(k)

        with metricsmod.timed("graphs.capture"), torch.no_grad():
            graph, launched = _warm_and_capture(warm, body, dev, self._capture)
        return Capture(pack, key, inputs, graph, launched, time.perf_counter() - t0)


def _holds(cap: Capture, state) -> bool:
    """Whether `state` is `cap`'s buffers, as its step returned them: their
    values, changed in place since or not, are where the graph reads."""
    return len(state) == len(cap.inputs) and all(t is b for t, b in zip(state, cap.inputs))


def _warm_and_capture(warm: Callable[[], None], body: Callable[[], None], dev,
                      capture: Optional[Callable]):
    """Run `warm()` once eagerly (on a side stream on the card, as
    torch.cuda.graphs requires), then capture `body` on `dev` with
    `capture` (default `cuda_capture`).  Neither moves the launch counters.
    Returns (the graph, the warm-up's launches by kernel)."""
    counts = launch_counts()
    try:
        if dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                warm()
            torch.cuda.current_stream(dev).wait_stream(side)
        else:
            warm()
        after = launch_counts()
        graph = (capture or cuda_capture)(body, dev)
    finally:
        _set_launches(counts)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return graph, {k: after[k] - counts[k] for k in counts if after[k] != counts[k]}


def value_and_grad(fn: Callable, pack, *lanes):
    """`fn(pack, *lanes)`, a 0-d loss, and its gradients with respect to the
    pack's float tables (ScenePack.float_fields(), in that order; zeros
    where a table takes no part), eagerly.  `pack` holds the leaves
    (ScenePack.with_grad).  Returns (loss, grads), the loss detached."""
    leaves = [getattr(pack, f) for f in pack.float_fields()]
    loss = fn(pack, *lanes)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tuple(torch.zeros_like(x) if g is None else g
                                for x, g in zip(leaves, grads))


class GraphedGrad:
    """`step(pack, *lanes) -> (loss, grads)`: `value_and_grad(fn, ...)`
    with the forward and the whole backward pass replayed as one CUDA
    graph, the port's `jax.jit(jax.value_and_grad(loss))`.

    `fn(pack, *lanes)` returns a 0-d loss that is differentiable in the
    pack's float tables; `lanes` are tensors on the pack's device (pixel
    and sample ids, a target, the seed as a 0-d int64 tensor: core/rng.py
    takes it as it takes an int, so one capture serves every seed).  The
    step returns clones of the loss and of one gradient a float table, in
    ScenePack.float_fields() order, zeros where a table takes no part.

    One capture per device, for the last pack and lane layout seen there
    (another pack or lane shape is captured anew, never replayed through a
    stale graph).  The capture's leaves are `pack.with_grad()`, made once:
    they share storage with the pack's tables, so values written into
    those tables in place are read by the next replay.  The lanes are
    copied into static buffers before each replay.  A capture is preceded
    by one eager forward and backward on a side stream, with grad enabled,
    which builds the kernel library and what a checkpoint's recompute
    builds lazily, and counts the launches of one step (a remat "full"
    step launches its traversal again in the backward pass).  Neither the
    warm-up nor the capture moves the launch counters; each replay
    advances them by the warm-up's count.  The graph's private memory pool
    holds the step's activations while the capture lives; `release()`
    frees it.  Under metrics.debug_nans the step runs eagerly.

    `capture(body, device)` returns the graph of `body` (default
    `cuda_capture`); a test may stand in for it.
    """

    def __init__(self, fn: Callable, capture: Optional[Callable] = None):
        self.fn = fn
        self._capture = capture
        self.captures: Dict[torch.device, Capture] = {}
        self.replays = 0   # replays issued, each span `grad.replay`'s unit

    def __call__(self, pack, *lanes):
        if metricsmod.nan_checks():
            return value_and_grad(self.fn, pack.with_grad(), *lanes)
        dev = pack.device
        key = tuple((t.shape, t.dtype) for t in lanes)
        cap = self.captures.get(dev)
        if cap is None or cap.key != key or not same_pack(cap.pack, pack):
            self.release(dev)
            cap = self.captures[dev] = self._record(pack, lanes, key)
        self.replays += 1
        with metricsmod.span("grad.replay", self.replays):
            for buf, t in zip(cap.inputs, lanes):
                buf.copy_(t)
            counts = launch_counts()
            cap.graph.replay()
            _set_launches({k: n + cap.launched.get(k, 0) for k, n in counts.items()})
            loss, grads = cap.outputs[0]
            return loss.clone(), tuple(g.clone() for g in grads)

    def release(self, device=None) -> None:
        """Drop the capture on `device` (every capture without one): its
        graph, its memory pool and its static buffers."""
        for dev in list(self.captures) if device is None else [device]:
            cap = self.captures.pop(dev, None)
            if cap is not None and hasattr(cap.graph, "reset"):
                cap.graph.reset()

    def _record(self, pack, lanes, key) -> Capture:
        t0 = time.perf_counter()
        dev = pack.device
        leaves = pack.with_grad()
        inputs = tuple(t.clone() for t in lanes)
        outputs = []

        def body():
            outputs[:] = [value_and_grad(self.fn, leaves, *inputs)]

        def warm():
            body()
            outputs.clear()

        with metricsmod.timed("graphs.capture"), torch.enable_grad():
            graph, launched = _warm_and_capture(warm, body, dev, self._capture)
        return Capture(pack, key, inputs, graph, launched, time.perf_counter() - t0, outputs)


class LoopGraph:
    """`prologue(); while cond: body(); epilogue()` as one CUDA graph: the
    port of a jitted function around a `lax.while_loop` (the reference's
    `jax.jit(batch_fn)`, render/renderer.py:77, whose trace loops in
    render/integrator.py:248-256).  One `launch()` runs the whole loop on
    the card; the host reads nothing between bodies.

    The stages are functions of no arguments that read and write static
    tensors.  After each body, ops/loop_cond.py's kernel reads the 0-d
    `any_alive` (bool) and `depth` (int64) the body wrote, writes `flag` =
    any_alive & (depth < max_depth), adds one to `bounces`, and sets the
    graph's conditional WHILE node from the flag.  The condition starts
    each launch true (when max_depth > 0), so the first body always runs;
    the prologue must leave the lanes alive at depth 0, as the eager loop's
    first test requires.  The prologue should zero `bounces`.

    Building it runs each stage once eagerly on a side stream (it builds
    the kernel library and lazily built constants, and counts the body's
    launches), captures each on that stream into a torch.cuda.CUDAGraph
    (keep_graph=True, one shared memory pool: they run in capture order),
    then assembles and instantiates prologue -> WHILE { body -> loop_cond }
    -> epilogue with the runtime's graph API (csrc/loop_cond.cu).  Neither
    the warm-up nor the capture moves the launch counters.  A replay does not know how
    many bodies ran: after reading `bounces`, the caller calls `count(n)`,
    which advances the counters by n times the body's launches and n
    loop_cond launches.  The graph is built, instantiated and launched
    with `any_alive`'s device current: its loop_cond node and its
    executable belong to that device's context, as the captures do.  The
    captures, and the tensors they address, live as long as this object;
    the instantiated graph is destroyed with it.  A failure raises;
    nothing runs eagerly instead.
    """

    def __init__(self, prologue: Callable[[], None], body: Callable[[], None],
                 epilogue: Callable[[], None], any_alive, depth, flag, bounces,
                 max_depth: int):
        with metricsmod.timed("graphs.capture"):
            t0 = time.perf_counter()
            dev = any_alive.device
            counts = launch_counts()
            try:
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.no_grad(), torch.cuda.stream(side):
                    prologue()
                    before = launch_counts()
                    body()
                    after = launch_counts()
                    epilogue()
                torch.cuda.current_stream(dev).wait_stream(side)
                self.captures, pool = [], None
                for stage in (prologue, body, epilogue):
                    g = torch.cuda.CUDAGraph(keep_graph=True)
                    # on `side`, not torch.cuda.graph's default stream (cuda_capture)
                    with torch.no_grad(), torch.cuda.device(dev), \
                            torch.cuda.graph(g, pool=pool, stream=side):
                        stage()
                    pool = g.pool() if pool is None else pool
                    self.captures.append(g)
            finally:
                _set_launches(counts)
            self.launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            self.launched["loop_cond"] = 1
            self.device = dev
            self._handles = loop_cond.build_graph(*(g.raw_cuda_graph() for g in self.captures),
                                                  any_alive, depth, flag, bounces, max_depth)
            weakref.finalize(self, loop_cond.destroy_graph, *self._handles)
            torch.cuda.synchronize(dev)
            self.seconds = time.perf_counter() - t0

    def launch(self) -> None:
        """One run of the loop, on the current stream of its device."""
        loop_cond.launch_graph(self._handles[1], self.device)

    def count(self, bounces: int) -> None:
        """Advance the launch counters by a run of `bounces` bodies."""
        _set_launches({k: n + bounces * self.launched.get(k, 0)
                       for k, n in launch_counts().items()})


class PlainLoop:
    """LoopGraph's plain form, for the CPU: the same stages run eagerly,
    and the condition through ops/loop_cond.py's wrapper (its plain
    version on CPU tensors), read on the host after each body.  The
    wrappers count their own calls, so `count` does nothing."""

    def __init__(self, prologue, body, epilogue, any_alive, depth, flag, bounces,
                 max_depth: int):
        self.stages = prologue, body, epilogue
        self.cond = any_alive, depth, flag, bounces, max_depth

    def launch(self) -> None:
        prologue, body, epilogue = self.stages
        flag, max_depth = self.cond[2], self.cond[4]
        with torch.no_grad():
            prologue()
            go = max_depth > 0
            while go:
                body()
                loop_cond.loop_cond(*self.cond)
                go = bool(flag)
            epilogue()

    def count(self, bounces: int) -> None:
        pass


def loop_graph(*args, **kwargs):
    """A LoopGraph on a CUDA device, its PlainLoop on the CPU (the arguments
    as LoopGraph's; the device is `any_alive`'s)."""
    cls = LoopGraph if args[3].device.type == "cuda" else PlainLoop
    return cls(*args, **kwargs)


def cached(cache: dict, pins: tuple, values: tuple, build: Callable):
    """cache's entry for (the objects `pins`, by identity, and the hashable
    `values`), made by `build()` at first use.  The pins are kept beside
    the entry, so their ids are not reused while it lives.  The cache holds
    the newest entry of each kind (`values[0]`, as "pool" or "batch"): a
    new entry drops the older ones of its kind, and with them their graphs
    and memory pools, before it is built."""
    kind = values[0]
    key = (kind, tuple(id(p) for p in pins)) + tuple(values[1:])
    if key not in cache:
        for old in [k for k in cache if k[0] == kind]:
            del cache[old]
        cache[key] = (pins, build())
    return cache[key][1]
