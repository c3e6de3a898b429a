"""Hold the free-flight kernel KV-FF (rust_raytracer_torch/csrc/free_flight.cu
via ops/vertex.py:free_flight) against its plain version,
ops/intersect.py:merge_volumes, on the card, and time both.

    python3 scripts/free_flight_check.py        # on the GPU, ~1 min

Sets, each at 2^18 lanes: the inputs of pool steps recorded from eager
1-spp renders (a bounce a lane; the drain step's dead lanes) of
cornell_smoke (two rotated boxes; first, mid and drain steps) and of
cornell_dragon with a fog sphere (mid step, the BVH8 walk's hits);
random rays through cornell_smoke with a sphere, a sheared box and a
352-triangle sphere mesh added (every boundary kind: chip_smoke.py's
volume_kinds_scene) and through three seeded scenes of rotated boxes and
ellipsoids in the smoke's room, a bounce a lane, a seed above 2^31,
1/16 of the lanes dead (a zero direction) and 256 axis-parallel; and
one random set with one bounce for every lane and the seed as a 0-d
device tensor (the batch bounce's key).  On a set both versions take the
same hits (the plain KV1 and the walk's) and RNG key; the script prints
the lanes whose t (NaN = NaN), kind or prim differ, which must be none,
and holds one replay of a CUDA graph of the kernel against its eager
call bit for bit.

Times are on the smoke's mid step, by CUDA events: the kernel's around
one replay of a graph of KERNEL_REPS calls (the device's time) and as
many eager calls, the plain version's around PLAIN_REPS eager calls.  The
bound is the bytes the lanes move once over 3.35 TB/s: 84 a lane (ray 24,
six hit fields 24, pixel, sample and bounce 24 in; t, kind, prim 12 out),
and beside it the benchmark's count (free_flight_roofline_pct.render:
60 a live lane).
"""
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

from vertex_parity import (LANES, PEAK_BYTES, fog_scene, log, pick,  # noqa: E402
                           record_states, time_graphed_ms, time_ms)

KERNEL_REPS, PLAIN_REPS = 50, 3
LANE_BYTES, READER_LANE_BYTES = 84, 60
SEED = 3100000106


def random_scene(g, smoke, seed):
    """The smoke's room with two rotated boxes and two ellipsoids (a
    sphere scaled unevenly, then rotated) of medium, drawn from `seed`."""
    r = np.random.default_rng(seed)
    white = g.Lambertian(g.Constant((0.73, 0.73, 0.73)))
    items = [it for it in smoke.world.items if not isinstance(it, g.Volume)]
    for k in range(4):
        if k % 2 == 0:
            shape = g.Transform(g.Box((0, 0, 0), tuple(r.uniform(4.0, 16.0, 3)), white))
        else:
            shape = g.Transform(g.Sphere((0, 0, 0), float(r.uniform(3.0, 8.0)), white))
            shape.scale(*(float(x) for x in r.uniform(0.5, 1.8, 3)))
        shape.rotate_x(float(r.uniform(-60, 60))).rotate_y(float(r.uniform(-60, 60)))
        shape.rotate_z(float(r.uniform(-60, 60)))
        shape.translate(*(float(x) for x in r.uniform(-15.0, 15.0, 3)))
        items.append(g.Volume(shape, g.Isotropic(g.Constant((0.9, 0.9, 0.9))),
                              float(r.uniform(0.02, 0.3))))
    return g.SceneDef(world=g.Group(items), lights=smoke.lights, config=dict(smoke.config))


def random_lanes(dev, seed, bounce_lanes=True):
    """(org, dirn, alive, ctx) of LANES random rays in the smoke's room."""
    from rust_raytracer_torch.core import rng as vrng

    r = np.random.default_rng(seed)
    org = r.uniform(-27.0, 27.0, (LANES, 3)).astype(np.float32)
    dirn = r.normal(size=(LANES, 3)).astype(np.float32)
    k = np.arange(256)
    dirn[k] = 0.0
    dirn[k, k % 3] = np.where(k % 2, 1.0, -1.0)
    dead = r.uniform(size=LANES) < 1 / 16
    dirn[dead] = 0.0
    pixel = torch.arange(LANES, device=dev) * 7 + 3
    sample = torch.from_numpy(r.integers(0, 225, LANES)).to(dev)
    if bounce_lanes:
        ctx = vrng.Ctx(pixel, sample, torch.from_numpy(r.integers(0, 20, LANES)).to(dev), SEED)
    else:
        ctx = vrng.Ctx(pixel, sample, 5, torch.tensor(SEED).to(dev))
    return (torch.from_numpy(org).to(dev), torch.from_numpy(dirn).to(dev),
            torch.from_numpy(~dead).to(dev), ctx)


def hits_of(pack, org, dirn, alive):
    """The plain KV1's hits and the walk's, and T_MIN's lanes."""
    from rust_raytracer_torch.ops import intersect as isect
    from rust_raytracer_torch.render import integrator

    tl = torch.full((org.shape[0],), integrator.T_MIN, device=org.device)
    t_sph, i_sph, t_pln, i_pln, tri_tmax = isect.analytic_hits(pack, org, dirn, tl, alive)
    t_tri, i_tri = isect.intersect_triangles(pack, org, dirn, integrator.T_MIN, tri_tmax)
    return (t_sph, i_sph, t_pln, i_pln, t_tri.contiguous(), i_tri.contiguous()), tl


def unequal(got, want):
    """Lanes whose t (NaN = NaN), kind or prim differ."""
    t_same = (got[0] == want[0]) | (torch.isnan(got[0]) & torch.isnan(want[0]))
    return ~t_same | (got[1] != want[1]) | (got[2] != want[2])


def hold(tag, pack, static, org, dirn, alive, ctx):
    """One set: the kernel against merge_volumes; returns the count of
    lanes that differ and the set's inputs."""
    from rust_raytracer_torch.ops import intersect as isect
    from rust_raytracer_torch.ops import vertex
    from rust_raytracer_torch.render import integrator
    from rust_raytracer_torch.scene import pack as sp

    with torch.no_grad():
        hits, tl = hits_of(pack, org, dirn, alive)
        want = isect.merge_volumes(pack, org, dirn, tl, ctx, *hits)
        got = vertex.free_flight(pack, static, org, dirn, ctx, integrator.T_MIN, hits)
    bad = unequal(got, want)
    n_bad = int(bad.sum())
    kinds = np.bincount(want[1].cpu().numpy(), minlength=7).tolist()
    per_vol = np.bincount(want[2][want[1] == sp.PRIM_VOLUME].cpu().numpy(),
                          minlength=len(pack.vol_kinds)).tolist()
    fin = torch.isfinite(got[0]) & torch.isfinite(want[0])
    dt = float((got[0][fin].double() - want[0][fin].double()).abs().max()) if bool(
        fin.any()) else 0.0
    log(f"  free flight, {tag}: {org.shape[0]} lanes ({int((~alive).sum())} dead), volumes "
        f"{list(pack.vol_kinds)} (kinds: 0 sphere 1 box 2 mesh), hits by kind (none sphere "
        f"plane triangle volume sky sun) {kinds}, by volume {per_vol}; lanes not bit-equal "
        f"{n_bad}, max |dt| {dt:.3e}")
    if n_bad:
        log(f"  free flight, {tag}: the lanes that differ, plain kinds "
            f"{np.bincount(want[1][bad].cpu().numpy(), minlength=7).tolist()}, kernel kinds "
            f"{np.bincount(got[1][bad].cpu().numpy(), minlength=7).tolist()}")
    return n_bad, dict(org=org, dirn=dirn, ctx=ctx, hits=hits, tl=tl, want=want, got=got,
                       alive=alive)


def graphed_equals_eager(pack, static, inp):
    """One replay of a captured kernel call against the eager call."""
    from rust_raytracer_torch.ops import vertex
    from rust_raytracer_torch.render import integrator

    def call():
        return vertex.free_flight(pack, static, inp["org"], inp["dirn"], inp["ctx"],
                                  integrator.T_MIN, inp["hits"])

    eager = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    return int(unequal(out, eager).sum())


def times(pack, static, inp, card):
    from rust_raytracer_torch.ops import intersect as isect
    from rust_raytracer_torch.ops import vertex
    from rust_raytracer_torch.render import integrator

    org, dirn, ctx, hits, tl = inp["org"], inp["dirn"], inp["ctx"], inp["hits"], inp["tl"]

    def kernel():
        return vertex.free_flight(pack, static, org, dirn, ctx, integrator.T_MIN, hits)

    with torch.no_grad():
        k_ms = time_graphed_ms(kernel, KERNEL_REPS)
        e_ms = time_ms(kernel, KERNEL_REPS)
        p_ms = time_ms(lambda: isect.merge_volumes(pack, org, dirn, tl, ctx, *hits), PLAIN_REPS)
    n, live = org.shape[0], int(inp["alive"].sum())
    bound = n * LANE_BYTES / PEAK_BYTES * 1e3
    reader = live * READER_LANE_BYTES / PEAK_BYTES * 1e3
    log(f"time free_flight x{n} ({live} live): kernel {k_ms:.4f} ms (graph of {KERNEL_REPS} "
        f"calls; eager back to back {e_ms:.4f} ms), plain merge_volumes {p_ms:.4f} ms (eager, "
        f"{PLAIN_REPS} calls; CUDA events); bound {bound:.4f} ms by bytes ({LANE_BYTES} B a "
        f"lane; {bound / k_ms:.1%} of the kernel's time), the benchmark's count "
        f"{reader:.4f} ms ({READER_LANE_BYTES} B a live lane; {reader / k_ms:.1%}) ({card})")
    return dict(ms=k_ms, eager_ms=e_ms, plain_ms=p_ms, bound_ms=bound, reader_bound_ms=reader)


def run(card):
    """Every set (see the module docstring); raises where a lane differs or
    the graph's replay differs from the eager call.  Returns the times."""
    from chip_smoke import volume_kinds_scene
    from rust_raytracer_torch import models
    from rust_raytracer_torch.core import rng as vrng
    from rust_raytracer_torch.render.camera import camera_from_config
    from rust_raytracer_torch.scene import compiler
    from rust_raytracer_torch.scene import graph as g
    from rust_raytracer_torch.utils import config as cfg

    dev = torch.device("cuda:0")
    smoke = models.build("cornell_smoke")
    dragon = models.build("cornell_dragon")
    bad, timed = {}, None

    def recorded(name, scene, width, tags):
        nonlocal timed
        sc = cfg.merge_scene_config(scene.config, {"output_width": width})
        camera = camera_from_config(sc, cfg.RenderConfig(samples_per_pixel=1, max_depth=20))
        pack, static = compiler.compile_scene(scene, dev)
        t0 = time.perf_counter()
        states = record_states(pack, static, camera, "auto", seed=SEED)
        log(f"free flight sets, {name}: {len(states)} steps recorded "
            f"({time.perf_counter() - t0:.1f} s)")
        for tag, s in pick(states):
            if not tag.split()[0] in tags:
                continue
            ctx = vrng.Ctx(s.pixel, s.sample, s.bounce, SEED)
            key = f"{name} {tag}"
            bad[key], inp = hold(key, pack, static, s.org, s.dirn, s.active, ctx)
            if tag.startswith("mid"):
                bad[f"{key}, graphed vs eager"] = graphed_equals_eager(pack, static, inp)
                if timed is None:
                    timed = times(pack, static, inp, card)
        del states

    recorded("cornell_smoke", smoke, 1200, ("first", "mid", "drain"))
    recorded("cornell_dragon + fog", fog_scene(g, dragon), 600, ("mid",))
    randoms = [("every boundary kind", volume_kinds_scene(g, smoke), True)]
    randoms += [(f"random volumes {k}", random_scene(g, smoke, k), True) for k in (1, 2, 3)]
    randoms.append(("every boundary kind, one bounce", volume_kinds_scene(g, smoke), False))
    for k, (name, scene, lanes) in enumerate(randoms):
        pack, static = compiler.compile_scene(scene, dev)
        bad[name], inp = hold(name, pack, static, *random_lanes(dev, 40 + k, lanes))
        if k == 0:
            bad[f"{name}, graphed vs eager"] = graphed_equals_eager(pack, static, inp)
    worst = max(bad.values())
    log(f"free flight parity: {len(bad)} checks, lanes not bit-equal {sum(bad.values())} "
        f"(worst {worst}) ({card})")
    if worst:
        raise AssertionError(f"the free-flight kernel differs from merge_volumes: {bad}")
    return timed


def main():
    if not torch.cuda.is_available():
        raise SystemExit("free_flight_check: needs a CUDA GPU")
    from rust_raytracer_torch.ops import _cuda, vertex

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    t0 = time.perf_counter()
    _cuda.build_library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    a = vertex.attributes()["free_flight"]
    log(f"free_flight_kernel: {a['registers']} registers, {a['local_bytes']} local bytes, "
        f"{a['shared_bytes']} static shared bytes")
    t0 = time.perf_counter()
    run(card)
    log(f"free flight check: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
