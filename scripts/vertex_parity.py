"""Hold the path vertex kernels (rust_raytracer_torch/ops/vertex.py: KV1
vertex_hit, KV2 vertex_shade, KV3 lane_update, lane_bbox and
compaction_key, KV4 pool_refill) against their plain PyTorch versions on the card, and time
both.

    python3 scripts/vertex_parity.py            # on the GPU, ~1-2 min

Each set is the input of a pool step recorded from an eager render at
2^18 lanes: cornell_dragon through the BVH8 walk and through the wavefront
pipeline (its first, a mid-render and a drain step), cornell_dragon with a
fog sphere (volume hits), a card under a sky and a sun, and
tests/test_torch_scene.py's texture scene, whose program has every node
kind (image, checker, solid checker, Perlin marble and turbulence, lerp,
channel, uv), with every material, the same scene with one sphere
under a rotation and a non-uniform scale (every sphere then takes the
affine branch of KV1 and KV2), and golden_monkey at 1200x800 (461
spheres under KV1's sphere BVH; its first step: camera rays through the
aperture, and a mid-render step: bounces).  On
a set, each kernel and its plain version get the same inputs: KV1 the
step's rays; KV2 the plain KV1's hits and the walk's; KV3 the plain KV2's
shading; the box, the key and KV4 the plain KV3's lanes, KV4 the plain
key's sort and the plain dead count.
For each output the script prints the lanes that are not bit-equal
(NaN = NaN) and max |d| over the finite ones, and for KV2 the hit kinds
and material types of the lanes that differ; `chip_smoke.py` runs the same
sets (`run`) and fails where a kernel's share of unequal lanes passes its
bound (TOLERANCE).

Times are on one set's inputs (the mid BVH8 step), by CUDA events: a
kernel's around one replay of a CUDA graph of KERNEL_REPS calls of its
wrapper (the device's time, without the host's launch cost), and around
as many back-to-back eager calls (the wrapper's rate, which the host sets
for kernels this short); a plain version's around PLAIN_REPS eager calls.
The box's library call is torch.aminmax.  A bound is the larger of the
bytes the set's lanes must read and write once (counted from the set's data
where a lane's reads depend on it) over 3.35 TB/s and their f32 operations
(counted per lane below) over 67 TFLOP/s (NVIDIA H100 SXM).
"""
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

LANES = 1 << 18
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
KERNEL_REPS, PLAIN_REPS = 50, 3
KV1, KV2, KV3, BOX, KEY, KV4 = ("vertex_hit", "vertex_shade", "lane_update", "lane_bbox",
                                "compaction_key", "pool_refill")
# the share of a set's lanes that may differ from the plain version in an
# output, by kernel: none.  The kernels repeat the plain versions'
# operations in their order (-fmad=false), and their f32 math functions
# (sinf, cosf, logf, acosf, atan2f) are the ones PyTorch's CUDA kernels
# call; every lane of every set was bit-equal on the H100 (PERF.md §6)
TOLERANCE = dict.fromkeys((KV1, KV2, KV3, BOX, KEY, KV4), 0.0)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_graphed_ms(fn, reps):
    """ms a call of `fn` on the device: CUDA events around one replay of a
    CUDA graph of `reps` calls, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def diff(got, want):
    """(lanes not bit-equal, max |d| over finite pairs) of two (n, ...)
    tensors; NaN equals NaN."""
    if got.dtype.is_floating_point:
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        d = (got.double() - want.double()).abs()
        d = d[torch.isfinite(d)]
    else:
        same = got == want
        d = (got.long() - want.long()).abs().double()
    while same.dim() > 1:
        same = same.all(dim=-1)
    return int((~same).sum()), float(d.max()) if d.numel() else 0.0


# ---------------------------------------------------------------- scenes

def sky_sun_scene(g):
    """A diffuse card under an open sky and a sun (chip_smoke.py's
    sky_card_scene with a sun): most paths end in the sky or the sun."""
    corners = np.array([[-0.3, -0.3, 0.0], [0.3, -0.3, 0.0], [0.3, 0.3, 0.0], [-0.3, 0.3, 0.0]])
    tris = np.zeros((2, 3, 3), np.int32)
    tris[:, :, 0] = [[0, 1, 2], [0, 2, 3]]
    tris[:, :, 2] = -1
    card = g.Mesh(corners, np.array([[0.0, 0.0, 1.0]]), np.zeros((0, 2)), tris,
                  g.Lambertian(g.Constant((0.2, 0.7, 0.2))))
    sky = g.Sky(g.Constant((0.5, 0.7, 1.0)))
    sun = g.Sun((0.2, 0.3, 1.0), g.Constant((20.0, 18.0, 15.0)))
    return g.SceneDef(world=g.Group([card, sky, sun]), lights=[sky, sun], config={})


def fog_scene(g, dragon):
    """cornell_dragon with one fog sphere (chip_smoke.py:fog_pool_render's)."""
    white = g.Lambertian(g.Constant((0.73, 0.73, 0.73)))
    fog = g.Volume(g.Sphere((150.0, 120.0, 150.0), 100.0, white),
                   g.Isotropic(g.Constant((1.0, 1.0, 1.0))), 0.01)
    return g.SceneDef(world=g.Group(list(dragon.world.items) + [fog]), lights=dragon.lights,
                      config=dict(dragon.config))


def affine_scene(g, scene):
    """`scene` with one more sphere under a rotation and a scale of (1, 2,
    1): every sphere of the scene then takes the affine branch of KV1 and
    KV2 (its rows' inverse and forward matrices)."""
    ellipsoid = g.Transform(g.Sphere((0.0, 0.0, 0.0), 0.5, g.Lambertian(g.Checker(
        g.Constant((0.9, 0.8, 0.2)), g.Constant((0.1, 0.2, 0.7)), 0.05))))
    ellipsoid = ellipsoid.scale(1.0, 2.0, 1.0).rotate_z(30.0).rotate_x(20.0).translate(
        -0.4, 0.2, 2.2)
    return g.SceneDef(world=g.Group(list(scene.world.items) + [ellipsoid]),
                      lights=scene.lights, config=dict(scene.config))


def small_camera(Camera, position, look_at, width=512, depth=8, f_number=None):
    """A width x width camera (2^18 pixels at 512) at 1 spp."""
    return Camera(image_width=width, aspect_ratio=1.0, samples_per_pixel=1, max_depth=depth,
                  position=position, look_at=look_at, focal_length=35.0, f_number=f_number)


# ---------------------------------------------------------------- recording

def record_states(pack, static, camera, kernel, seed=0):
    """The input state of every eager pool step of a 1-spp render at LANES
    lanes, until every job is issued and no lane is live."""
    from rust_raytracer_torch.render import pool as poolmod

    n_pixels = camera.image_width * camera.image_height
    step = poolmod.make_step(pack, static, camera, n_pixels, 1, seed, kernel=kernel,
                             graph=False)
    state = poolmod.init_state(LANES, n_pixels, pack.device)
    states = []
    for _ in range(poolmod.max_pool_steps(n_pixels, LANES, camera.max_depth)):
        states.append(state)
        state = step(pack, state)
        if len(states) % 10 == 0 and int(state.next_flat) >= n_pixels \
                and not bool(state.active.any()):
            break
    return states


def pick(states):
    """(tag, state) of the first step with live lanes, a mid-render step
    and a drain step (the first past the middle with fewer than half the
    lanes live)."""
    live = [float(s.active.float().mean()) for s in states]
    first = next(k for k, x in enumerate(live) if x > 0)
    mid = len(states) // 2
    drain = next((k for k in range(mid + 1, len(states)) if live[k] < 0.5), len(states) - 1)
    return [(f"first (step {first + 1})", states[first]), (f"mid (step {mid + 1})", states[mid]),
            (f"drain (step {drain + 1})", states[drain])]


# ---------------------------------------------------------------- one set

class Report:
    """Per kernel: the worst count of unequal lanes and max |d| of each
    output over the sets, the sets' lanes."""

    def __init__(self):
        self.outs = {}
        self.lanes = 0
        self.worst_share = dict.fromkeys(TOLERANCE, 0.0)

    def add(self, name, tag, n, pairs):
        parts = []
        for out, (got, want) in pairs.items():
            cnt, maxd = diff(got, want)
            key = (name, out)
            old = self.outs.get(key, (0, 0.0))
            self.outs[key] = (max(old[0], cnt), max(old[1], maxd))
            self.worst_share[name] = max(self.worst_share[name], cnt / max(n, 1))
            parts.append(f"{out} {cnt} ({maxd:.3e})")
        log(f"  {name}, {tag}: lanes not bit-equal (max |d|): " + ", ".join(parts))

    def max_abs_err(self, name):
        return max((v[1] for (k, _), v in self.outs.items() if k == name), default=0.0)


def hold_set(rep, tag, pack, static, camera, s, kernel, seed=0, quota=None):
    """Each kernel against its plain version on pool-step input `s`."""
    from rust_raytracer_torch.core import rng as vrng
    from rust_raytracer_torch.ops import intersect as isect
    from rust_raytracer_torch.ops import vertex
    from rust_raytracer_torch.render import integrator
    from rust_raytracer_torch.render import pool as poolmod
    from rust_raytracer_torch.scene import pack as sp

    n = s.org.shape[0]
    quota = camera.image_width * camera.image_height if quota is None else quota
    t_min = integrator.T_MIN
    lb = camera.light_bias
    ctx = vrng.Ctx(pixel=s.pixel, sample=s.sample, bounce=s.bounce, seed=seed)
    with torch.no_grad():
        tl = torch.full((n,), t_min, dtype=torch.float32, device=s.org.device)
        hits_p = isect.analytic_hits(pack, s.org, s.dirn, tl, s.active)
        hits_k = vertex.analytic_hits(pack, static, s.org, s.dirn, t_min, s.active)
        rep.add(KV1, tag, n, dict(zip(("t_sph", "i_sph", "t_pln", "i_pln", "tri_tmax"),
                                      zip(hits_k, hits_p))))
        t_tri, i_tri, stats = isect.intersect_triangles(pack, s.org, s.dirn, t_min, hits_p[4],
                                                        kernel=kernel, return_stats=True)
        hit = isect.close_hits(pack, s.org, s.dirn, tl, ctx, *hits_p[:4], t_tri, i_tri)
        shade_p = integrator.shade_hits(pack, static, s.org, s.dirn, hit, ctx, lb)
        merged = None
        if pack.vol_kinds:
            merged = isect.merge_volumes(pack, s.org, s.dirn, tl, ctx, *hits_p[:4], t_tri, i_tri)
        shade_k = vertex.shade_hits(pack, static, s.org, s.dirn, ctx, lb,
                                    (*hits_p[:4], t_tri, i_tri), merged)
        names = ("emission", "weight", "new_dir", "ended", "pos")
        rep.add(KV2, tag, n, dict(zip(names, zip(shade_k, shade_p))))
        bad = torch.zeros(n, dtype=torch.bool, device=s.org.device)
        for got, want in zip(shade_k, shade_p):
            same = (got == want) | (torch.isnan(got) & torch.isnan(want)) \
                if got.dtype.is_floating_point else got == want
            bad |= ~(same.all(dim=-1) if same.dim() > 1 else same)
        if bool(bad.any()):
            mtype = pack.mat_type[isect.hit_attributes(pack, s.org, s.dirn, hit).mat.long()]
            kinds = np.bincount(hit.kind[bad].cpu().numpy(), minlength=7)
            mats = np.bincount(mtype[bad].cpu().numpy(), minlength=7)
            log(f"  {KV2}, {tag}: the {int(bad.sum())} lanes that differ by hit kind "
                f"(none sphere plane triangle volume sky sun) {kinds.tolist()}, by material "
                f"(lambertian metal dielectric glossy emissive isotropic debug) "
                f"{mats.tolist()}; volume hits in the set "
                f"{int((hit.kind == sp.PRIM_VOLUME).sum())}")

        lanes_p = poolmod.update_plain(s, *shade_p, camera.max_depth)
        upd = vertex.lane_update(s.org, s.dirn, s.throughput, s.radiance, s.active, *shade_p,
                                 bounce=s.bounce, max_depth=camera.max_depth)
        lanes_k = (*upd[:4], s.pixel, s.sample, *upd[4:7])
        n_dead = (~lanes_p[7]).sum().view(1)
        pairs = {f: (a, b) for f, a, b in zip(
            ("org", "dirn", "throughput", "radiance", "pixel", "sample", "bounce", "still",
             "retired"), lanes_k, lanes_p) if f not in ("pixel", "sample")}
        rep.add(KV3, tag, n, {**pairs, "n_dead": (upd[7], n_dead)})
        box_p = torch.stack([lanes_p[0].amin(dim=0), lanes_p[0].amax(dim=0)])
        rep.add(BOX, tag, 2, {"lo, hi": (vertex.lane_box(lanes_p[0]).view(2, 3), box_p)})
        key_p = integrator._compaction_key(lanes_p[0], lanes_p[1], lanes_p[7])
        rep.add(KEY, tag, n, {"key": (vertex.compaction_key(lanes_p[0], lanes_p[1], lanes_p[7]),
                                      key_p)})
        perm = torch.sort(key_p, stable=True).indices
        want = poolmod.refill_plain(s, perm, lanes_p, stats["wf_overflow"], camera, quota, 0, 1,
                                    seed)
        out = vertex.pool_refill(perm, lanes_p, n_dead, s.next_flat, s.overflow,
                                 stats["wf_overflow"], vertex.camera_table(camera, s.org.device),
                                 quota, 0, 1, camera.image_width, camera.sqrt_spt,
                                 camera.aperture_radius is not None, seed)
        got = poolmod.PoolState(*out[:8], accum=s.accum.index_add(0, out[8], out[9]),
                                next_flat=out[10], overflow=out[11])
        pairs = {f: (getattr(got, f), getattr(want, f)) for f in poolmod.PoolState._fields
                 if f not in ("accum", "next_flat", "overflow")}
        rep.add(KV4, tag, n, pairs)
        acc_d = float((got.accum.double() - want.accum.double()).abs().max())
        if not (int(got.next_flat) == int(want.next_flat)
                and int(got.overflow) == int(want.overflow)):
            raise AssertionError(f"{KV4}, {tag}: next_flat {int(got.next_flat)} / "
                                 f"{int(want.next_flat)}, overflow {int(got.overflow)} / "
                                 f"{int(want.overflow)}")
        log(f"  {KV4}, {tag}: image accumulator max |d| {acc_d:.3e} (index_add's atomics sum "
            f"in no fixed order), next_flat and overflow equal")
    return dict(hits=hits_p, walk=(t_tri, i_tri, stats), shade=shade_p, lanes=lanes_p,
                n_dead=n_dead, perm=perm, merged=merged, ctx=ctx, tl=tl)


def bounds(pack, static, camera, s, inp):
    """Per kernel (bound ms, "bytes" | "operations") at the set's lanes."""
    from rust_raytracer_torch.ops import vertex
    from rust_raytracer_torch.render import integrator

    n = s.org.shape[0]
    ns, np_ = pack.sph_center.shape[0], pack.pln_corner.shape[0]
    nl = len(static.light_list)
    node_ops = {0: 0, 1: 12, 2: 12, 3: 12, 4: 9, 6: 0, 7: 0}
    prog = sum(node_ops.get(nd.kind, 8 * 30 * nd.samples + 20) for nd in static.tex_program)
    t_tri, i_tri, _ = inp["walk"]
    tri_rows = int(torch.unique(i_tri[i_tri >= 0]).numel())
    live = int(s.active.sum())
    quota = camera.image_width * camera.image_height
    issued = max(0, min(int(inp["n_dead"]), quota - int(s.next_flat)))
    # bytes the set's lanes read and write once (see each csrc file); the
    # update reads weight and ended on a live lane only, the refill a kept
    # lane's org, dirn, throughput, sample and bounce only
    moved = {KV1: n * (24 + 1 + 20),
             # ray 24, the six hit fields 24, pixel, sample and bounce 24;
             # four (n, 3) outputs and ended; each triangle row hit, once
             KV2: n * (24 + 24 + 24 + 48 + 1) + tri_rows * 128,
             KV3: n * (69 + 58) + live * 13,
             BOX: n * 12 + 24,
             KEY: n * (25 + 8),
             KV4: n * (30 + 93) + (n - issued) * 52}
    # KV1: a plane ~45; with spheres, ~80 a node visit (two boxes) and ~40
    # a sphere test, the walk's own counts on the set
    kv1_ops = 5 + 45 * np_
    if ns:
        counts = torch.zeros(2, dtype=torch.int64, device=s.org.device)
        vertex.analytic_hits(pack, static, s.org, s.dirn, integrator.T_MIN, s.active, counts)
        kv1_ops += (80 * int(counts[0]) + 40 * int(counts[1])) / max(live, 1)
    ops = {KV1: kv1_ops,
           # merge ~20, hit record ~120, program, shading ~150, the NEE
           # sample ~60 and pdf ~60 a light, six pcg4d draws of ~40
           KV2: 20 + 120 + prog + 150 + 60 + 60 * nl + 6 * 40,
           KV3: 20, BOX: 6, KEY: 45, KV4: 80}
    out = {}
    for name in TOLERANCE:
        b = moved[name] / PEAK_BYTES * 1e3
        o = n * ops[name] / PEAK_FLOPS * 1e3
        out[name] = (b, "bytes") if b >= o else (o, "operations")
    return out


def times(pack, static, camera, s, kernel, inp, card, seed=0):
    """(kernel ms, plain ms, bound ms, bound by, kernel ms eager, library ms
    or None) of each kernel on set `s` (see the module docstring)."""
    from rust_raytracer_torch.ops import intersect as isect
    from rust_raytracer_torch.ops import vertex
    from rust_raytracer_torch.render import integrator
    from rust_raytracer_torch.render import pool as poolmod

    n = s.org.shape[0]
    quota = camera.image_width * camera.image_height
    t_min, lb, ctx, tl = integrator.T_MIN, camera.light_bias, inp["ctx"], inp["tl"]
    hits, (t_tri, i_tri, stats), shade, lanes = (inp["hits"], inp["walk"], inp["shade"],
                                                inp["lanes"])
    n_dead, perm = inp["n_dead"], inp["perm"]
    cam = vertex.camera_table(camera, s.org.device)
    box = vertex.lane_box(lanes[0])

    def hit_plain():
        return integrator.shade_hits(pack, static, s.org, s.dirn, isect.close_hits(
            pack, s.org, s.dirn, tl, ctx, *hits[:4], t_tri, i_tri), ctx, lb)

    def refill_plain():
        return poolmod.refill_plain(s, perm, lanes, stats["wf_overflow"], camera, quota, 0, 1,
                                    seed)

    def refill_kernel():
        out = vertex.pool_refill(perm, lanes, n_dead, s.next_flat, s.overflow,
                                 stats["wf_overflow"], cam, quota, 0, 1, camera.image_width,
                                 camera.sqrt_spt, camera.aperture_radius is not None, seed)
        return s.accum.index_add(0, out[8], out[9])

    pairs = {
        KV1: (lambda: vertex.analytic_hits(pack, static, s.org, s.dirn, t_min, s.active),
              lambda: isect.analytic_hits(pack, s.org, s.dirn, tl, s.active)),
        KV2: (lambda: vertex.shade_hits(pack, static, s.org, s.dirn, ctx, lb,
                                        (*hits[:4], t_tri, i_tri), inp["merged"]), hit_plain),
        KV3: (lambda: vertex.lane_update(s.org, s.dirn, s.throughput, s.radiance, s.active,
                                         *shade, bounce=s.bounce, max_depth=camera.max_depth),
              lambda: poolmod.update_plain(s, *shade, camera.max_depth)),
        BOX: (lambda: vertex.lane_box(lanes[0]),
              lambda: (lanes[0].amin(dim=0), lanes[0].amax(dim=0))),
        KEY: (lambda: vertex.compaction_key(lanes[0], lanes[1], lanes[7], box),
              lambda: integrator._compaction_key(lanes[0], lanes[1], lanes[7])),
        KV4: (refill_kernel, refill_plain),
    }
    library = {BOX: lambda: torch.aminmax(lanes[0], dim=0)}
    out = {}
    with torch.no_grad():
        for name, (k, p) in pairs.items():
            lib = time_ms(library[name], KERNEL_REPS) if name in library else None
            out[name] = (time_graphed_ms(k, KERNEL_REPS), time_ms(p, PLAIN_REPS),
                         time_ms(k, KERNEL_REPS), lib)
    b = bounds(pack, static, camera, s, inp)
    for name, (k_ms, p_ms, e_ms, lib) in out.items():
        lib_txt = "" if lib is None else f", library call {lib:.4f} ms"
        log(f"time {name} x{n}: kernel {k_ms:.4f} ms (graph of {KERNEL_REPS} calls; eager "
            f"back to back {e_ms:.4f} ms), plain {p_ms:.4f} ms (eager, {PLAIN_REPS} calls; CUDA "
            f"events){lib_txt}; bound {b[name][0]:.4f} ms by {b[name][1]} "
            f"({b[name][0] / k_ms:.1%} of the kernel's time) ({card})")
    return {name: (out[name][0], out[name][1], *b[name], out[name][2], out[name][3])
            for name in out}


def run(card, dragon=None, bvh8_renderer=None, wf_renderer=None):
    """Every set (see the module docstring); returns (Report, times of the
    mid BVH8 set).  The dragon renderers are built unless given."""
    from rust_raytracer_torch import models
    from rust_raytracer_torch.ops import vertex
    from rust_raytracer_torch.render import integrator
    from rust_raytracer_torch.render.camera import Camera, camera_from_config
    from rust_raytracer_torch.render.renderer import Renderer
    from rust_raytracer_torch.scene import compiler
    from rust_raytracer_torch.scene import graph as g
    from rust_raytracer_torch.utils import config as cfg
    from test_torch_scene import texture_scene   # imports no JAX at import time

    dev = torch.device("cuda:0")
    rep = Report()
    if dragon is None:
        dragon = models.build("cornell_dragon")
    if bvh8_renderer is None:
        sc = cfg.merge_scene_config(dragon.config, {"output_width": 1200})
        camera = camera_from_config(sc, cfg.RenderConfig(samples_per_pixel=1, max_depth=20))
        bvh8_renderer = Renderer(dragon, camera, batch_size=LANES, kernel="auto", device=dev)
    camera = bvh8_renderer.camera
    timed = None
    for r in (bvh8_renderer, wf_renderer):
        if r is None:
            continue
        t0 = time.perf_counter()
        states = record_states(r.pack, r.static, camera, r.kernel)
        log(f"vertex sets, cornell_dragon, {r.kernel}: {len(states)} steps recorded "
            f"({time.perf_counter() - t0:.1f} s)")
        for tag, s in pick(states):
            inp = hold_set(rep, f"{r.kernel} {tag}", r.pack, r.static, camera, s, r.kernel)
            if timed is None and tag.startswith("mid"):
                timed = times(r.pack, r.static, camera, s, r.kernel, inp, card)
        del states
    others = (("fog", fog_scene(g, dragon), camera),
              ("sky and sun", sky_sun_scene(g),
               small_camera(Camera, (0.0, 0.2, 2.0), (0.0, 0.0, 0.0), f_number=4.0)),
              ("every texture node", texture_scene(g),
               small_camera(Camera, (0.0, 1.0, 7.0), (0.0, 0.0, 0.0))),
              ("affine sphere", affine_scene(g, texture_scene(g)),
               small_camera(Camera, (0.0, 1.0, 7.0), (0.0, 0.0, 0.0))))
    for name, scene, cam in others:
        pack, static = compiler.compile_scene(scene, dev)
        states = record_states(pack, static, cam, "auto")
        for tag, s in pick(states)[1:2]:
            inp = hold_set(rep, f"{name} {tag}", pack, static, cam, s, "auto")
            if pack.sph_inv.shape[0]:
                log(f"  {name} {tag}: {int((inp['hits'][1] >= 0).sum())} of {s.org.shape[0]} "
                    f"lanes hit a sphere, each through the affine rows")
        del states, pack
    monkey = models.build("golden_monkey")
    cam = camera_from_config(cfg.merge_scene_config(monkey.config, {"output_width": 1200}),
                             cfg.RenderConfig(samples_per_pixel=1, max_depth=20))
    pack, static = compiler.compile_scene(monkey, dev)
    states = record_states(pack, static, cam, "auto")
    for tag, s in pick(states)[:2]:
        inp = hold_set(rep, f"golden_monkey {tag}", pack, static, cam, s, "auto")
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        vertex.analytic_hits(pack, static, s.org, s.dirn, integrator.T_MIN, s.active, counts)
        live = max(int(s.active.sum()), 1)
        log(f"  golden_monkey {tag}: {int((inp['hits'][1] >= 0).sum())} of {s.org.shape[0]} "
            f"lanes hit a sphere; KV1's walk: {int(counts[0]) / live:.2f} node visits, "
            f"{int(counts[1]) / live:.2f} sphere tests a live lane (the loop: "
            f"{pack.sph_center.shape[0]})")
    del states, pack
    for name, share in rep.worst_share.items():
        log(f"vertex parity {name}: worst share of a set's lanes not bit-equal {share:.3e} "
            f"(bound {TOLERANCE[name]:.0e}), max |d| {rep.max_abs_err(name):.3e}")
        if share > TOLERANCE[name]:
            raise AssertionError(f"{name} disagrees with its plain version on {share:.3e} "
                                 f"of a set's lanes")
    return rep, timed


def main():
    if not torch.cuda.is_available():
        raise SystemExit("vertex_parity: needs a CUDA GPU")
    import subprocess

    from rust_raytracer_torch.ops import _cuda, vertex

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    t0 = time.perf_counter()
    _cuda.build_library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, a in vertex.attributes().items():
        log(f"{name}_kernel: {a['registers']} registers, {a['local_bytes']} local bytes, "
            f"{a['shared_bytes']} static shared bytes")
    run(card)


if __name__ == "__main__":
    main()
