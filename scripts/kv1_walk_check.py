"""Hold KV1, the vertex hit kernel (csrc/vertex_hit.cu via
ops/vertex.py:analytic_hits), which walks a BVH of the scene's spheres,
against the plain loop over every sphere and against another checkout's
KV1 on the same lanes, on the card, and time it in turns.

    python3 scripts/kv1_walk_check.py --other chipcheck/parent   # on the GPU, ~3 min
    python3 scripts/kv1_walk_check.py --device cpu --small       # a rehearsal on the CPU

The sets: golden_monkey at 1200x800 with its f/2.8 aperture, the eager
pool steps of a 1-spp render at 2^18 lanes (the first: camera rays; a
mid-render step: bounces; a drain step); golden_monkey's camera rays
over the whole view (the first step's lanes are the image's top rows,
all sky); rays of golden_monkey from the
spheres' surfaces, along their boxes' faces and tangent to them; planted
ties (tests/test_torch_sphere_bvh.py's scenes: two spheres of one centre
and radius, and a mirrored pair in two leaves hit at equal t); the affine
field (rotated, non-uniformly scaled spheres); and cornell_dragon's mid
step (no sphere: the walk is not entered).  On each set this checkout's
KV1 is held against the plain version (ops/intersect.py:analytic_hits):
t_sph, i_sph, t_pln, i_pln and tri_tmax bit for bit (NaN = NaN); against
its own replay in a CUDA graph; and, on the sets with spheres, against the
float32 emulation of the walk in torch ops (test_torch_sphere_bvh.walk),
whose node visits and sphere tests a lane are printed beside the kernel's
counter.  Then KV1 of --other, of this checkout, of this checkout, of
--other, each in a process of its own (this script with --worker) that
builds its package's kernels and scenes, runs its KV1 on the saved rays
and times it (CUDA events around one replay of a graph of --reps calls);
every run's outputs must equal the first's bit for bit.  Prints the card's
name and power limit, a line a set (lanes, live lanes, node visits and
sphere tests a live lane), a time line a set, and one JSON line.  Keeps
the rays and the runs' outputs under build/kv1_walk/.

On the CPU (--device cpu) the plain loop stands in for KV1 (there is no
kernel), so a rehearsal checks the plumbing, not the kernel; --small cuts
the images, the pool and the sets.
"""
import argparse
import json
import os
import sys
import time

sys.modules["jax"] = None  # the port runs without JAX

import numpy as np  # noqa: E402
import torch  # noqa: E402

from in_turns import (build, card, pick, record, run_in_turns,  # noqa: E402
                      this_over_other, time_graphed_ms, unequal)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "kv1_walk")
LANES, SMALL_LANES = 1 << 18, 2048
WIDTH = {"golden_monkey": 1200, "cornell_dragon": 1200}
OUTPUTS = ("t_sph", "i_sph", "t_pln", "i_pln", "tri_tmax")
T_MIN = 1e-3


def log(*a):
    print(*a, flush=True)


def planted(name, dev):
    """(pack, static) of a planted scene of tests/test_torch_sphere_bvh.py."""
    import test_torch_sphere_bvh as tb
    from rust_raytracer_torch.scene import compiler
    from rust_raytracer_torch.scene import graph as g

    if name == "affine":
        scene = tb.affine_field(g)
    elif name == "twice":
        scene = tb.field_scene(g, tb.same_sphere_twice())
    else:
        scene = tb.field_scene(g, tb.mirrored_pair(lower_first=False))
    return compiler.compile_scene(scene, dev)


def scene_of(set_name, small, dev):
    """(pack, static) a set's rays are traced in."""
    scene = set_name.split(" ")[0]
    if scene in WIDTH:
        return build(scene, WIDTH[scene], small, dev)[:2]
    return planted(scene, dev)


def ray_sets(small, dev):
    """{set name: (org, dirn, alive)} (see the module docstring)."""
    import test_torch_sphere_bvh as tb

    lanes = SMALL_LANES if small else LANES
    sets = {}
    for name in WIDTH:
        t0 = time.perf_counter()
        pack, static, camera = build(name, WIDTH[name], small, dev)
        states = record(pack, static, camera, lanes)
        log(f"{name}: {camera.image_width}x{camera.image_height}, {len(states)} steps recorded "
            f"({time.perf_counter() - t0:.1f} s), {pack.sph_center.shape[0]} spheres")
        for tag, s in pick(states, name == "golden_monkey"):
            sets[f"{name} {tag}"] = (s.org, s.dirn, s.active)
        if name == "golden_monkey":
            rng = np.random.default_rng(7)
            sets["golden_monkey camera"] = (*tb.camera_rays(rng, lanes), None)
            sets["golden_monkey from the surfaces"] = (*tb.surface_rays(pack, rng, lanes // 4),
                                                       None)
            sets["golden_monkey grazing"] = (*tb.grazing_rays(pack, rng, lanes // 8), None)
        del states, pack
    rng = np.random.default_rng(11)
    n = lanes // 8
    sets["twice"] = (*tb.camera_rays(rng, n, position=(3.0, 2.0, 5.0), look_at=(0.5, 0.2, 0.5),
                                     half_fov=0.08), None)
    sets["mirrored"] = (*tb.mirror_plane_rays(rng, n), None)
    sets["affine"] = (*tb.camera_rays(rng, n, position=(6.0, 4.0, 8.0), look_at=(0.0, 0.5, 0.0),
                                      half_fov=0.5), None)
    return {k: tuple(None if x is None else x.to(dev).contiguous() for x in v)
            for k, v in sets.items()}


def kv1(pack, static, org, dirn, alive, counts=None):
    """KV1 of the imported package (its plain version on the CPU)."""
    from rust_raytracer_torch.ops import vertex

    if org.device.type == "cpu":
        return plain(pack, org, dirn, alive)
    if counts is None:
        return vertex.analytic_hits(pack, static, org, dirn, T_MIN, alive)
    return vertex.analytic_hits(pack, static, org, dirn, T_MIN, alive, counts)


def plain(pack, org, dirn, alive):
    from rust_raytracer_torch.ops import intersect as isect

    tl = torch.full((org.shape[0],), T_MIN, dtype=torch.float32, device=org.device)
    with torch.no_grad():
        return isect.analytic_hits(pack, org, dirn, tl, alive)


def graphed_outputs(fn, dev):
    """The outputs of one replay of a graph of one call of `fn`."""
    fn()
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    graph.replay()
    torch.cuda.synchronize(dev)
    return tuple(x.clone() for x in out)


def worker(args):
    """KV1 of the package at --worker on the saved rays: its outputs and ms
    a set."""
    sys.path.insert(0, os.path.abspath(args.worker))
    sys.path.insert(1, os.path.join(HERE, "tests"))
    from rust_raytracer_torch.ops import _cuda, vertex

    dev = torch.device(args.device)
    if dev.type == "cuda":
        _cuda.build_library()
    saved = torch.load(args.inputs, map_location=dev)
    out = {"root": os.path.abspath(args.worker)}
    built = {}
    for name, (org, dirn, alive) in saved.items():
        key = name.split(" ")[0]
        if key not in built:
            built[key] = scene_of(name, args.small, dev)
            if dev.type == "cuda":
                vertex.tables(*built[key])
        pack, static = built[key]
        with torch.no_grad():
            got = kv1(pack, static, org, dirn, alive)
            ms = time_graphed_ms(lambda: kv1(pack, static, org, dirn, alive), args.reps, dev)
        out[name] = {"out": tuple(x.cpu() for x in got), "ms": ms}
    torch.save(out, args.out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another checkout of this repo (its KV1 is held equal)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("kv1_walk_check: torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    sys.path.insert(1, os.path.join(HERE, "tests"))
    import test_torch_sphere_bvh as tb
    from rust_raytracer_torch.ops import _cuda, vertex

    log(f"card: {card()}")
    if dev.type == "cuda":
        _cuda.build_library()
        log(f"vertex_hit_kernel: {_cuda.attributes('rrt_vertex_hit')}")
    sets = ray_sets(args.small, dev)
    result = {"card": card(), "sets": {}}
    built = {}
    for name, (org, dirn, alive) in sets.items():
        key = name.split(" ")[0]
        if key not in built:
            built[key] = scene_of(name, args.small, dev)
        pack, static = built[key]
        n = org.shape[0]
        live = n if alive is None else int(alive.sum())
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        with torch.no_grad():
            got = kv1(pack, static, org, dirn, alive, counts)
            want = plain(pack, org, dirn, alive)
        bad = {o: unequal(a, b) for o, a, b in zip(OUTPUTS, got, want)}
        line = {"lanes": n, "live": live, "lanes not bit-equal to the plain loop": bad}
        if dev.type == "cuda":
            graphed = graphed_outputs(lambda: kv1(pack, static, org, dirn, alive), dev)
            line["lanes not bit-equal graphed"] = {o: unequal(a, b)
                                                   for o, a, b in zip(OUTPUTS, graphed, got)}
            visits, tests = counts.tolist()
            line["node visits, sphere tests a live lane (kernel)"] = (visits / max(live, 1),
                                                                      tests / max(live, 1))
        ns = pack.sph_center.shape[0]
        if ns:
            f, i = vertex.table_arrays(pack, static)
            with torch.no_grad():
                cand = tb.candidates(pack, org, dirn)
                t_e, i_e, v_e, s_e = tb.walk(f, i, org, dirn, cand)
            on = torch.ones(n, dtype=torch.bool, device=dev) if alive is None else alive
            line["lanes not equal to the emulated walk"] = (unequal(t_e, want[0])
                                                            + unequal(i_e, want[1]))
            line["node visits, sphere tests a live lane (emulated)"] = (
                float(v_e[on].double().sum()) / max(live, 1),
                float(s_e[on].double().sum()) / max(live, 1))
            del cand
        log(f"{name}: KV1 vs plain: {json.dumps(line)}")
        if any(bad.values()) or any(line.get("lanes not bit-equal graphed", {}).values()) \
                or line.get("lanes not equal to the emulated walk", 0):
            raise AssertionError(f"{name}: KV1 differs: {line}")
        result["sets"][name] = line
    del built
    os.makedirs(OUT, exist_ok=True)
    torch.save({k: tuple(None if x is None else x.cpu() for x in v) for k, v in sets.items()},
               os.path.join(OUT, "inputs.pt"))

    runs = run_in_turns(__file__, HERE, args.other, OUT,
                        ["--inputs", os.path.join(OUT, "inputs.pt"), "--device", args.device,
                         "--reps", str(args.reps)] + (["--small"] if args.small else []))
    first = runs[0][1]
    for side, run in runs:
        for name in sets:
            bad = [unequal(a, b) for a, b in zip(run[name]["out"], first[name]["out"])]
            if any(bad):
                raise AssertionError(f"{name}: {side} ({run['root']}) differs from the first "
                                     f"run: {dict(zip(OUTPUTS, bad))}")
    for name in sets:
        ms = {}
        for side, run in runs:
            ms.setdefault(side, []).append(run[name]["ms"])
        result["sets"][name]["ms"] = ms
        ratio = this_over_other(ms)
        if ratio is not None:
            result["sets"][name]["this_over_other"] = ratio
        per = result["sets"][name].get("node visits, sphere tests a live lane (kernel)")
        counts = "" if per is None else (f"; node visits {per[0]:.2f}, sphere tests "
                                         f"{per[1]:.2f} a live lane")
        log(f"time KV1 {name}: {json.dumps(ms)} ms (a graph of {args.reps} calls, CUDA events)"
            f"{'' if ratio is None else f', this / other {ratio:.4f}'}{counts}"
            f"; the outputs of every run equal bit for bit ({result['card']})")
    log(json.dumps(result))


if __name__ == "__main__":
    main()
