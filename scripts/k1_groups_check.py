"""Hold K1, the BVH8 walk with its grouped leaf test (csrc/bvh8_traverse.cu
via ops/bvh8.py), against another checkout's K1 on the same rays, on the
card, and time both in turns.

    python3 scripts/k1_groups_check.py --other chipcheck/parent   # on the GPU, ~2 min
    python3 scripts/k1_groups_check.py --device cpu --small       # a rehearsal on the CPU

Builds cornell_dragon at 1200x1200 with this checkout's package and makes
chip_smoke.py's ray sets at 2^18 lanes: primary rays over the whole image,
a bounce wavefront from their hits, those bounce rays with the t_max mix
(+inf, 0, 3.4e38, capped at half the hit), and the primary and bounce
rays in the compaction-sort order the renderers trace them in.  Holds
this checkout's K1 on each set against chip_smoke.py:bvh8_walk (the walk
in torch ops with ops/bvh8.py:leaf_test_plain): (t, slot) equal, slots
included, and K1's counter equal to the walk's leaf visits and groups
tested; one replay of a CUDA graph of K1 against its eager call; and
the leaf tables the device built against the CPU's, bit for bit.
Then runs K1 of --other, of this checkout, of this checkout, of --other,
each in a process of its own (this script with --worker) that builds its
package's kernels and scene pack, times K1 on each set (CUDA events, mean
of --reps calls after one) and keeps its (t, slot); every run's (t, slot)
must equal the first's bit for bit.  Prints the card's name and power
limit, a line a set, and one JSON line of the times, counts and shares.
Keeps the rays and the runs' outputs under build/k1_groups/.

--small builds chip_smoke.py's mini scene (a 960-triangle torus knot in
the Cornell shell) at 64 lanes a set; on the CPU K1's wrapper runs the
plain walk, so a CPU run checks the plumbing, not the kernel.
"""
import argparse
import json
import os
import sys
import time

sys.modules["jax"] = None  # the port runs without JAX

import torch  # noqa: E402

from in_turns import card, run_in_turns, this_over_other  # noqa: E402

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "k1_groups")
W, LANES, SMALL_LANES = 1200, 1 << 18, 64
SETS = ("primary", "bounce", "bounce t_max mix", "sorted primary", "sorted bounce")


def build_scene(small):
    """The scene graph and its camera at width W (64 with `small`)."""
    from rust_raytracer_torch import models
    from rust_raytracer_torch.models import builtin
    from rust_raytracer_torch.render.camera import camera_from_config
    from rust_raytracer_torch.scene import graph as g
    from rust_raytracer_torch.utils import config as cfg
    from rust_raytracer_torch.utils import procgen

    scene = models.build("cornell_dragon")
    if small:
        mat_white, walls = builtin._cornell_shell()
        mat_gloss = g.Glossy(g.Constant((0.73, 0.73, 0.73)), g.Constant(0.0), 1.5)
        light = g.Plane((277.5, 554.9, 277.5), (-130, 0, 0), (0, 0, -105),
                        g.Emissive(g.Constant((15.0, 15.0, 15.0))), render_backface=True)
        knot = g.Transform(procgen.torus_knot_mesh(mat_gloss, rings=40, segments=12))
        knot.scale(110).rotate_y(225).translate(267.5, 200.0, 277.5)
        scene = g.SceneDef(
            world=g.Group([g.Plane((277.5, 0, 277.5), (277.5, 0, 0), (0, 0, -277.5), mat_white)]
                          + walls + [light, knot]),
            lights=[light], config=dict(scene.config))
    conf = cfg.merge_scene_config(scene.config, {"output_width": 64 if small else W})
    return scene, camera_from_config(conf, cfg.RenderConfig(samples_per_pixel=1, max_depth=20))


def time_ms(fn, reps, dev):
    """ms a call: CUDA events around `reps` calls after one (the host's
    clock on the CPU)."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def make_rays(pack, camera, n, dev):
    """chip_smoke.py's sets: {name: (org, dirn, t_max)}."""
    import chip_smoke as cs
    from rust_raytracer_torch.ops import threaded

    org, dirn = cs.make_rays(camera, n, dev)
    big = torch.full((n,), 3.4e38, dtype=torch.float32, device=dev)
    t, slot = threaded.traverse_plain(pack, org, dirn, big)
    org2, dirn2 = cs.bounce_rays(org, dirn, t, slot)
    t2, slot2 = threaded.traverse_plain(pack, org2, dirn2, big)
    sets = {"primary": (org, dirn, big), "bounce": (org2, dirn2, big),
            "bounce t_max mix": (org2, dirn2, cs.t_max_mix(t2, slot2).contiguous())}
    for tag, (o, d, _) in (("sorted primary", sets["primary"]), ("sorted bounce", sets["bounce"])):
        sets[tag] = (*cs.sort_rays(o, d), big)
    return sets


def worker(args):
    """K1 of the package at --worker on the saved rays: (t, slot) and ms
    a set, and the counter where the package's K1 has one."""
    sys.path.insert(0, os.path.abspath(args.worker))
    import inspect

    from rust_raytracer_torch.ops import _cuda, bvh8
    from rust_raytracer_torch.scene import compiler

    dev = torch.device(args.device)
    if dev.type == "cuda":
        _cuda.build_library()
    scene, _ = build_scene(args.small)
    pack, _ = compiler.compile_scene(scene, dev)
    rays = torch.load(args.rays, map_location=dev)
    counted = "counts" in inspect.signature(bvh8.intersect_triangles_bvh8).parameters
    out = {"root": os.path.abspath(args.worker), "counted": counted}
    for tag in SETS:
        o, d, tm = rays[tag]
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        kw = {"counts": counts} if counted else {}
        t, slot = bvh8.intersect_triangles_bvh8(pack, o, d, None, tm, **kw)
        ms = time_ms(lambda: bvh8.intersect_triangles_bvh8(pack, o, d, None, tm), args.reps, dev)
        out[tag] = {"t": t.cpu(), "slot": slot.cpu(), "ms": ms, "counts": counts.tolist()}
    torch.save(out, args.out)


def graph_equal(bvh8, pack, o, d, tm, dev):
    """One replay of a captured K1 call equals its eager call."""
    if dev.type != "cuda":
        return None
    eager = bvh8.intersect_triangles_bvh8(pack, o, d, None, tm)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        bvh8.intersect_triangles_bvh8(pack, o, d, None, tm)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = bvh8.intersect_triangles_bvh8(pack, o, d, None, tm)
    graph.replay()
    torch.cuda.synchronize(dev)
    return torch.equal(got[0], eager[0]) and torch.equal(got[1], eager[1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another checkout of this repo (its K1 is held equal)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--rays", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("k1_groups_check: torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from rust_raytracer_torch.ops import _cuda, bvh8
    from rust_raytracer_torch.scene import compiler
    from rust_raytracer_torch.scene import pack as tpack

    print(f"card: {card()}", flush=True)
    if dev.type == "cuda":
        _cuda.build_library()
        print(f"bvh8_traverse_kernel: {_cuda.attributes('rrt_bvh8_traverse')}", flush=True)
    scene, camera = build_scene(args.small)
    t0 = time.perf_counter()
    pack, _ = compiler.compile_scene(scene, dev)
    n_cl = pack.tri_rows.shape[0] // 128
    rows, box = tpack.bvh8_leaf_tables(pack.tri_rows.cpu())
    same = all(torch.equal(a.view(torch.int32), b.cpu().view(torch.int32)) for a, b in (
        (rows, pack.bvh8_leaf_rows), (box, pack.bvh8_leaf_box)))
    if not same:
        raise AssertionError("the leaf tables built on the CPU differ from the device's")
    print(f"scene: {n_cl} clusters, compile {time.perf_counter() - t0:.3f} s; leaf tables "
          f"built on {dev} equal the CPU's bit for bit", flush=True)
    sets = make_rays(pack, camera, SMALL_LANES if args.small else LANES, dev)
    os.makedirs(OUT, exist_ok=True)
    rays_path = os.path.join(OUT, "rays.pt")
    torch.save({k: tuple(x.cpu() for x in v) for k, v in sets.items()}, rays_path)

    result = {"card": card(), "sets": {}}
    for tag in SETS:
        o, d, tm = sets[tag]
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        got = bvh8.intersect_triangles_bvh8(pack, o, d, None, tm, counts)
        t_w, i_w, walk = cs.bvh8_walk(pack, o, d, tm)
        same = torch.equal(got[0], t_w) and torch.equal(got[1], i_w)
        counted = counts.tolist() == [walk["leaf_visits"], walk["groups"]]
        if dev.type == "cuda" and not (same and counted):
            raise AssertionError(f"{tag}: K1 vs bvh8_walk: (t, slot) equal {same}; counter "
                                 f"{counts.tolist()}, walk {walk['leaf_visits']}, {walk['groups']}")
        graphed = graph_equal(bvh8, pack, o, d, tm, dev)
        if graphed is False:
            raise AssertionError(f"{tag}: a graph replay of K1 differs from its eager call")
        share = walk["groups"] / max(4 * walk["leaf_visits"], 1)
        result["sets"][tag] = {"leaf_visits": walk["leaf_visits"], "groups": walk["groups"],
                               "group_share": share, "leaf_bytes": cs.leaf_bytes(walk),
                               "hits": int((i_w >= 0).sum())}
        print(f"{tag}: K1 = bvh8_walk slot for slot {same}, counter = walk {counted}, graph = "
              f"eager {graphed}; leaf visits {walk['leaf_visits']}, groups tested "
              f"{walk['groups']} ({share:.2%} of 4 a visit), bytes a leaf visit "
              f"{cs.leaf_bytes(walk):.0f}", flush=True)

    runs = run_in_turns(__file__, HERE, args.other, OUT,
                        ["--rays", rays_path, "--device", args.device, "--reps", str(args.reps)]
                        + (["--small"] if args.small else []))
    first = runs[0][1]
    for side, run in runs:
        for tag in SETS:
            a, b = first[tag], run[tag]
            if not (torch.equal(a["t"].view(torch.int32), b["t"].view(torch.int32))
                    and torch.equal(a["slot"], b["slot"])):
                raise AssertionError(f"{tag}: {side} ({run['root']}) differs from "
                                     f"{runs[0][0]} ({first['root']})")
    for tag in SETS:
        ms = {side: [] for side, _ in runs}
        for side, run in runs:
            ms[side].append(run[tag]["ms"])
        result["sets"][tag]["ms"] = ms
        if "other" in ms:
            result["sets"][tag]["this_over_other"] = this_over_other(ms)
        print(f"time {tag}: {json.dumps(ms)} ms (CUDA events, mean of {args.reps}); (t, slot) "
              f"of every run equal bit for bit", flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
