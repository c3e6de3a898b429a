"""The batch trace's bounce-loop stop test on the card, and the CUDA graph
that loops on it (csrc/loop_cond.cu): the port of the reference's
`lax.while_loop` condition (rust_raytracer_tpu/render/integrator.py:
248-256, `w_cond`: depth < max_depth and any lane alive).

`loop_cond(any_alive, depth, flag, bounces, max_depth)` writes flag =
any_alive & (depth < max_depth) into the 0-d uint8 `flag` and adds one to
the 0-d int64 `bounces`.  On CUDA tensors it launches the one-thread
kernel; on CPU tensors it runs the plain version (`flag_plain`).  Inside
the loop graph (`build_graph`) the same kernel also sets the graph's
conditional WHILE handle, so the card decides whether the next bounce
runs and the host reads nothing a bounce.

`build_graph` assembles prologue -> WHILE { body -> loop_cond } ->
epilogue from three graphs captured by PyTorch (their raw cudaGraph_t) and
instantiates it; `launch_graph` launches it on a stream;
`destroy_graph` frees it.  render/graphs.py:LoopGraph drives them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

# Launch counters: `launches` counts the kernel's launches (inside the loop
# graph, one a bounce: render/graphs.py:LoopGraph adds them after a run),
# `plain_calls` calls of the plain version through the wrapper.
launches = 0
plain_calls = 0


def flag_plain(any_alive, depth, max_depth: int):
    """The condition as torch ops: a 0-d bool, any_alive & (depth <
    max_depth).  `any_alive` may be the lanes' alive mask or its any()."""
    return any_alive.any() & (depth < max_depth)


def _check(any_alive, depth, flag, bounces):
    for name, t, dtype in (("any_alive", any_alive, torch.bool), ("depth", depth, torch.int64),
                           ("flag", flag, torch.uint8), ("bounces", bounces, torch.int64)):
        if t.dtype != dtype or t.dim() != 0:
            raise TypeError(f"{name} must be a 0-d {dtype} tensor, got {t.dtype} of "
                            f"shape {tuple(t.shape)}")
        if t.device != any_alive.device:
            raise ValueError(f"{name} is on {t.device}, any_alive on {any_alive.device}")


def loop_cond(any_alive, depth, flag, bounces, max_depth: int) -> None:
    """flag <- any_alive & (depth < max_depth); bounces += 1 (all 0-d)."""
    global launches, plain_calls
    _check(any_alive, depth, flag, bounces)
    if any_alive.device.type == "cuda":
        _cuda.launch("rrt_loop_cond", (any_alive, depth, flag, bounces), (int(max_depth),),
                     any_alive.device)
        launches += 1
        return
    plain_calls += 1
    flag.copy_(flag_plain(any_alive, depth, max_depth))
    bounces.add_(1)


def build_graph(prologue: int, body: int, epilogue: int, any_alive, depth, flag, bounces,
                max_depth: int):
    """The loop graph of three captured graphs (raw cudaGraph_t handles),
    built and instantiated on `any_alive`'s device: returns (graph, exec)
    handles.  The condition's default at each launch is max_depth > 0; the
    loop_cond node reads `any_alive` and `depth` after each body and writes
    `flag` and `bounces`.  Raises on a CUDA error."""
    _check(any_alive, depth, flag, bounces)
    vp = ctypes.c_void_p
    fn = _cuda.c_function("rrt_loop_graph_build",
                          [vp] * 7 + [ctypes.c_int, ctypes.POINTER(vp), ctypes.POINTER(vp)])
    graph, exe = vp(), vp()
    with torch.cuda.device(any_alive.device):
        err = fn(vp(prologue), vp(body), vp(epilogue), *(vp(t.data_ptr()) for t in
                                                         (any_alive, depth, flag, bounces)),
                 int(max_depth), ctypes.byref(graph), ctypes.byref(exe))
    if err != 0:
        raise RuntimeError(f"rrt_loop_graph_build: CUDA error {err} (conditional graph "
                           "nodes need CUDA 12.4 or later)")
    return graph.value, exe.value


def launch_graph(exe: int, device) -> None:
    """Launch the loop graph on the current stream of `device` (the device
    it was built on), with that device current."""
    fn = _cuda.c_function("rrt_loop_graph_launch", [ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(device):
        err = fn(ctypes.c_void_p(exe),
                 ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"rrt_loop_graph_launch: CUDA error {err}")


def destroy_graph(graph: int, exe: int) -> None:
    fn = _cuda.c_function("rrt_loop_graph_destroy", [ctypes.c_void_p, ctypes.c_void_p])
    err = fn(ctypes.c_void_p(graph), ctypes.c_void_p(exe))
    if err != 0:
        raise RuntimeError(f"rrt_loop_graph_destroy: CUDA error {err}")
