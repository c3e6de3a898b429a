"""What the kernel checks that hold one checkout's kernel against another's
share: the card's line, a builtin scene at a cut size, the recorded pool
steps of a 1-spp render and the steps picked from them, the lanes not bit
for bit equal, a graphed call's time, the workers run in turns (other,
this, this, other), each a process of its own that builds its package's
kernels, and the ratio of their times.

    from in_turns import card, run_in_turns, this_over_other
"""
import os
import subprocess
import sys
import time

import torch

SMALL_WIDTH = 48


def card() -> str:
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    if not torch.cuda.is_available():
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build(name, width, small, dev):
    """(pack, static, camera) of builtin `name` at `width` (SMALL_WIDTH with
    `small`, the knot cut to 40 x 16), 1 spp, depth 20."""
    from rust_raytracer_torch import models
    from rust_raytracer_torch.render.camera import camera_from_config
    from rust_raytracer_torch.scene import compiler
    from rust_raytracer_torch.utils import config as cfg
    from rust_raytracer_torch.utils import procgen

    if small:
        knot = procgen.torus_knot_mesh
        procgen.torus_knot_mesh = lambda m, **k: knot(m, **{**k, "rings": 40, "segments": 16})
    try:
        scene = models.build(name)
    finally:
        if small:
            procgen.torus_knot_mesh = knot
    conf = cfg.merge_scene_config(scene.config, {"output_width": SMALL_WIDTH if small else width})
    camera = camera_from_config(conf, cfg.RenderConfig(samples_per_pixel=1, max_depth=20))
    pack, static = compiler.compile_scene(scene, dev)
    return pack, static, camera


def record(pack, static, camera, lanes):
    """The input states of the eager pool steps of a 1-spp render."""
    from rust_raytracer_torch.render import pool as poolmod

    n_pixels = camera.image_width * camera.image_height
    step = poolmod.make_step(pack, static, camera, n_pixels, 1, 0, graph=False)
    state = poolmod.init_state(lanes, n_pixels, pack.device)
    states = []
    for _ in range(poolmod.max_pool_steps(n_pixels, lanes, camera.max_depth)):
        states.append(state._replace(accum=state.accum[:0]))
        state = step(pack, state)
        if int(state.next_flat) >= n_pixels and not bool(state.active.any()):
            break
    return states


def pick(states, every):
    """(tag, state): the first step with live lanes, a mid-render step and a
    drain step (the first past the middle with under half the lanes live);
    only the mid step unless `every`."""
    live = [float(s.active.float().mean()) for s in states]
    first = next(k for k, x in enumerate(live) if x > 0)
    mid = len(states) // 2
    drain = next((k for k in range(mid + 1, len(states)) if live[k] < 0.5), len(states) - 1)
    picked = [("first", first), ("mid", mid), ("drain", drain)] if every else [("mid", mid)]
    return [(f"{tag} (step {k + 1})", states[k]) for tag, k in picked]


def unequal(got, want):
    """Lanes of two (n, ...) tensors not bit-equal (NaN = NaN)."""
    if got.dtype.is_floating_point:
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    else:
        same = got == want
    while same.dim() > 1:
        same = same.all(dim=-1)
    return int((~same).sum())


def time_graphed_ms(fn, reps, dev):
    """ms a call: CUDA events around one replay of a graph of `reps` calls
    after a warm-up (the host's clock over `reps` eager calls on the CPU)."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_in_turns(script: str, here: str, other, out_dir: str, worker_args) -> list:
    """[(side, result)]: `script --worker ROOT --out PATH *worker_args` run
    for --other, this checkout, this checkout, --other (the others left out
    where `other` is None), each in a process of its own; a worker saves
    its result with torch.save at PATH."""
    order = [("other", other), ("this", here), ("this", here), ("other", other)]
    runs = []
    for k, (side, root) in enumerate(order):
        if root is None:
            continue
        path = os.path.join(out_dir, f"run{k}.pt")
        subprocess.run([sys.executable, os.path.abspath(script), "--worker", root, "--out", path,
                        *worker_args], check=True)
        runs.append((side, torch.load(path)))
    return runs


def this_over_other(ms: dict):
    """The mean of ms["this"] over the mean of ms["other"], None without
    both."""
    if not ms.get("this") or not ms.get("other"):
        return None
    return (sum(ms["this"]) / len(ms["this"])) / (sum(ms["other"]) / len(ms["other"]))
