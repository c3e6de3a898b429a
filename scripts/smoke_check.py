"""Checks on the card of the pool step's free-flight counter (the step's
`volume_hits`, counted by the shading kernel) and of what a graphed pool
step launches.

    python3 scripts/smoke_check.py [--root CHECKOUT] [--counter 0|1]

--counter 1 (this checkout's port only): a 96x96, 16-spp cornell_smoke
pool render, eager and graphed: the eager render's volume_hits against
the scattering events of live lanes counted from the merged hits that
reach the shading kernel (torch ops on the same tensors), the graphed
render's against the eager one's, and the two images.

Then, for cornell_dragon (no volume) and cornell_smoke, 2^18 lanes, one
graphed pool step replayed 40 times after 20: the device activities a
step by kind (kernels, copies, fills) from torch.profiler, the host's
CUDA runtime calls a step by name, and the mean device ms a step by CUDA
events.  --root runs another checkout's port (e.g. the parent commit's)
in its place, so two versions compare in one call.  Prints JSON lines.
"""
import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path


def counter_check(torch):
    from rust_raytracer_torch import models
    from rust_raytracer_torch.ops import vertex
    from rust_raytracer_torch.render.camera import Camera
    from rust_raytracer_torch.render.renderer import Renderer
    from rust_raytracer_torch.scene import pack as sp
    from rust_raytracer_torch.utils.metrics import RenderMetrics

    cam = Camera(image_width=96, aspect_ratio=1.0, focal_length=35.0, position=(0, 0, 110),
                 look_at=(0, 0, 0), samples_per_pixel=16, max_depth=20, light_bias=0.25)
    seen = []
    orig = vertex.shade_hits

    def shade_hits(pack, static, org, dirn, ctx, light_bias, hits, merged=None, alive=None,
                   *counters, **named):
        if merged is not None and alive is not None:
            seen.append(((merged[1] == sp.PRIM_VOLUME) & alive).sum())
        return orig(pack, static, org, dirn, ctx, light_bias, hits, merged, alive, *counters,
                    **named)

    out = {}
    for graph in (False, True):
        vertex.shade_hits = shade_hits if not graph else orig
        r = Renderer(models.build("cornell_smoke"), cam, seed=9, device="cuda")
        r.graph = graph
        m = RenderMetrics(n_pixels=96 * 96, spp=16, max_depth=20)
        img = r.render(mode="pool", metrics=m).accum
        out[graph] = (m.volume_hits, img)
    vertex.shade_hits = orig
    plain = int(sum(int(x) for x in seen))
    agree = float((abs(out[False][1] - out[True][1]) <= 1e-5 * abs(out[False][1]).max()).mean())
    ok = out[False][0] == plain == out[True][0] and plain > 0
    print(json.dumps({"check": "volume_hits", "eager": out[False][0], "graphed": out[True][0],
                      "plain_count": plain, "image_agreement": agree, "ok": ok}), flush=True)
    return ok


def step_launches(torch, scene_name: str, tag: str):
    from torch.profiler import ProfilerActivity, profile

    from rust_raytracer_torch import models
    from rust_raytracer_torch.render import pool
    from rust_raytracer_torch.render.camera import Camera
    from rust_raytracer_torch.scene import compiler

    scene = models.build(scene_name)
    if scene_name == "cornell_dragon":
        cam = Camera(image_width=1200, aspect_ratio=1.0, focal_length=33.0,
                     position=(277.5, 277.5, -800.0), look_at=(277.5, 277.5, 0.0),
                     samples_per_pixel=16, max_depth=20, light_bias=0.25)
    else:
        cam = Camera(image_width=600, aspect_ratio=1.0, focal_length=35.0,
                     position=(0.0, 0.0, 110.0), look_at=(0.0, 0.0, 0.0),
                     samples_per_pixel=225, max_depth=20, light_bias=0.25)
    pack, static = compiler.compile_scene(scene, "cuda")
    n_pixels, lanes = cam.image_width * cam.image_height, 1 << 18
    step = pool.make_step(pack, static, cam, n_pixels * cam.actual_spp, cam.actual_spp, 5)
    state = pool.init_state(lanes, n_pixels, "cuda")
    for _ in range(20):
        state = step(pack, state)
    torch.cuda.synchronize()
    n = 40
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state = step(pack, state)
        torch.cuda.synchronize()
    dev, host = Counter(), Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kind = ("copy" if e.name.startswith("Memcpy") else
                    "fill" if e.name.startswith("Memset") else "kernel")
            dev[kind] += 1
        elif e.name.startswith("cuda"):
            host[e.name] += 1
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state = step(pack, state)
    end.record()
    torch.cuda.synchronize()
    print(json.dumps({"check": "step_launches", "port": tag, "scene": scene_name,
                      "device_a_step": {k: v / n for k, v in sorted(dev.items())},
                      "host_calls_a_step": {k: v / n for k, v in sorted(host.items())},
                      "step_ms": start.elapsed_time(end) / n,
                      "fields": list(type(state)._fields)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--counter", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("smoke_check: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from rust_raytracer_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build_library()
    print(json.dumps({"root": args.root, "card": torch.cuda.get_device_name(0),
                      "build_s": time.perf_counter() - t0}), flush=True)
    ok = counter_check(torch) if args.counter else True
    for scene in ("cornell_dragon", "cornell_smoke"):
        step_launches(torch, scene, args.root)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
