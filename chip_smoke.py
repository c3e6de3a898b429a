"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the traversal kernels from rust_raytracer_torch/csrc, builds the
full ~870k-triangle cornell_dragon scene on the card, holds the BVH8 kernel
against its plain PyTorch version on 2^18 primary, bounce and capped/dead
rays (the pool width) and times both, checks that a small render on the
card agrees with the same render on the CPU, then renders cornell_dragon at
1200x1200, 1 spp, depth 20 through `Renderer(...).render(mode="pool")` with
2^18 lanes and checks that every pool step launched the kernel.  It renders
again with every pool step's traversal inputs recorded and holds the kernel
against the plain version on each, then splits a pool step's device time.

Then the same for the wavefront traversal (`kernel="wavefront"`, three
kernels: cull, compact, Möller–Trumbore): each kernel against its plain
version, and the pipeline against the BVH8 kernel, on the traversal inputs
that a wavefront render passes at its first, a mid-render and a drain
step, and on primary rays over the whole image; the dense single-level pipeline on 2^15 lanes; each kernel's time
against its plain version's; the wavefront main-path render, its launches,
overflow and image against the BVH8 render's; and its step split.

Any failed check raises, so the exit code is non-zero.  The last two lines
of standard output are a JSON line describing each kernel and the final
JSON result line.

Requires CUDA (exits non-zero without printing a result otherwise).  The
JAX reference package's jax-based modules are never imported: `jax` is
blocked at the top of this script.
"""
import json
import os
import statistics
import subprocess
import sys
import time

sys.modules["jax"] = None  # the port must run without JAX

import numpy as np  # noqa: E402
import torch  # noqa: E402

W, SPP, DEPTH, LANES = 1200, 1, 20, 1 << 18
HERE = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_rays(camera, n, device):
    """Primary rays of n pixels spread over the whole image (bench.py's
    column stride 7; rows spread evenly, where bench.py's stride 13 covers
    only the top rows at this width)."""
    from rust_raytracer_torch.core import rng as vrng

    ar = torch.arange(n, dtype=torch.int64, device=device)
    px = ar * 7 % camera.image_width
    py = ar * camera.image_height // n
    smp = torch.zeros_like(ar)
    ctx = vrng.Ctx(pixel=py * camera.image_width + px, sample=smp, bounce=0, seed=0)
    org, dirn = camera.generate_rays(px, py, smp, ctx)
    return org.contiguous(), dirn.contiguous()


def bounce_rays(org, dirn, t, slot):
    """A bounce-like wavefront, as bench.py:kernel_parity_check makes it:
    origins at the primary hits, directions from a seeded normal draw."""
    hit = slot >= 0
    t_h = torch.where(hit, t, torch.ones_like(t))
    org2 = (org + dirn * t_h[:, None]).contiguous()
    r = np.random.default_rng(0)
    d2 = r.normal(size=(org.shape[0], 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return org2, torch.from_numpy(d2).to(org.device)


def compare(pack, org, dirn, tag, t_max=None, quiet=False):
    """Kernel vs plain version on the same rays: equal hit masks, t within
    rtol 2e-5 / atol 1e-6, slot agreement >= 0.999, t == t_max on a miss.
    Returns the max abs t error and the slot agreement over lanes both hit,
    the hit count, and the kernel's (t, slot)."""
    from rust_raytracer_torch.ops import bvh8

    n = org.shape[0]
    if t_max is None:
        t_max = torch.full((n,), 3.4e38, dtype=torch.float32, device=org.device)
    t_k, i_k = bvh8.intersect_triangles_bvh8(pack, org, dirn, None, t_max)
    t_p, i_p = bvh8.traverse_plain(pack, org, dirn, t_max)
    torch.cuda.synchronize()
    hk, hp = i_k >= 0, i_p >= 0
    if not torch.equal(hk, hp):
        raise AssertionError(f"{tag}: hit masks differ on {(hk != hp).sum().item()} rays")
    both = hk & hp
    err = (t_k[both] - t_p[both]).abs()
    if both.any() and not torch.all(err <= 1e-6 + 2e-5 * t_p[both].abs()):
        raise AssertionError(f"{tag}: t differs, max abs err {err.max().item()}")
    if not torch.equal(t_k[~hk], t_max[~hk]):
        raise AssertionError(f"{tag}: missed rays do not return t_max")
    agree = (i_k[both] == i_p[both]).float().mean().item() if both.any() else 1.0
    if agree < 0.999:
        raise AssertionError(f"{tag}: slot agreement {agree} < 0.999")
    max_err = err.max().item() if both.any() else 0.0
    n_hit = int(both.sum())
    if not quiet:
        log(f"parity {tag}: {n} rays, hits {n_hit}, slot agreement "
            f"{agree:.6f}, max |dt| {max_err:.3e}")
    return max_err, agree, n_hit, (t_k, i_k)


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def light_region(camera, corners):
    """Pixel-space bounding box of a world-space quad seen by the camera."""
    pos = np.asarray(camera.position, np.float64)
    a = np.stack([np.zeros(3), -camera.pixel_delta_u, -camera.pixel_delta_v], 1)
    pts = []
    for c in corners:
        a[:, 0] = np.asarray(c, np.float64) - pos
        _, px, py = np.linalg.solve(a, camera.first_pixel - pos)
        pts.append((px, py))
    pts = np.asarray(pts)
    x0, y0 = np.ceil(pts.min(0)).astype(int) + 2
    x1, y1 = np.floor(pts.max(0)).astype(int) - 2
    return x0, x1, y0, y1


def pool_step_parity(renderer):
    """Render through the main path again with the traversal's inputs
    (org, dirn, t_max) recorded at every pool step, then hold the kernel
    against the plain version on each step's own inputs: primary and bounce
    rays in compaction order, t_max = +inf where no sphere or plane bounds
    the ray, 0 on dead lanes.  Returns the max abs t error."""
    from rust_raytracer_torch.ops import bvh8

    recorded = record_steps(renderer, bvh8, "intersect_triangles_bvh8")
    max_err, min_agree, rays, hits, inf_lanes, dead_lanes = 0.0, 1.0, 0, 0, 0, 0
    for k, (org, dirn, t_max) in enumerate(recorded):
        err, agree, n_hit, _ = compare(renderer.pack, org, dirn, f"pool step {k + 1}",
                                       t_max, quiet=True)
        max_err, min_agree = max(max_err, err), min(min_agree, agree)
        rays += org.shape[0]
        hits += n_hit
        inf_lanes += int(torch.isinf(t_max).sum())
        dead_lanes += int((t_max == 0).sum())
    if not (inf_lanes and dead_lanes):
        raise AssertionError("the pool steps passed no +inf or no dead (0) t_max")
    log(f"parity pool steps: {len(recorded)} steps, {rays} rays, hits {hits}, "
        f"t_max +inf on {inf_lanes}, 0 (dead) on {dead_lanes}; min slot agreement "
        f"{min_agree:.6f}, max |dt| {max_err:.3e}")
    return max_err


def step_split(renderer, camera, card, names, warm=10, steps=5):
    """Time `steps` steady-state pool steps of `renderer`'s path, then
    profile as many more: wall time, device time, and the share of each
    traversal kernel (matched by its `__global__` name).  The profiler
    slows the host, so device busy time is read against the unprofiled
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    from rust_raytracer_torch.render import pool as poolmod

    n_pixels = camera.image_width * camera.image_height
    total = n_pixels * SPP
    state = poolmod.init_state(LANES, n_pixels, renderer.pack.device)
    step = poolmod.make_step(renderer.pack, renderer.static, camera, total, SPP,
                             renderer.seed, kernel=renderer.kernel)
    for _ in range(warm):
        state = step(renderer.pack, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(renderer.pack, state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = step(renderer.pack, state)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    own = {nm: sum(e.self_device_time_total for e in kernels if nm in e.key) / 1e3 / steps
           for nm in names}
    trav_ms = sum(own.values())
    n_launch = sum(e.count for e in kernels) / steps
    shares = ", ".join(f"{nm} {ms:.3f} ms ({ms / dev_ms:.1%})" for nm, ms in own.items())
    log(f"pool step split ({renderer.kernel}): wall {wall_ms:.3f} ms/step (steps "
        f"{warm + 1}-{warm + steps}, profiler off); steps {warm + steps + 1}-"
        f"{warm + 2 * steps} profiled: wall {prof_ms:.3f} ms/step, device busy "
        f"{dev_ms:.3f} ms/step ({n_launch:.0f} kernels/step), traversal kernels "
        f"{trav_ms:.3f} ms/step [{shares}], rest {dev_ms - trav_ms:.3f} ms/step ({card})")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step  "
            f"x{e.count // steps:<4d} {e.key[:90]}")


def check_image(film, camera):
    """The film's HDR image: shape, finite, not black, and the light's
    pixels the brightest (median of the light region >= the image's 99th
    percentile).  Returns the image."""
    hdr = film.hdr()
    h = camera.image_height
    if hdr.shape != (h, W, 3) or not np.isfinite(hdr).all() or not hdr.mean() > 0:
        raise AssertionError(f"bad image: shape {hdr.shape}, mean {hdr.mean()}")
    lum = hdr.mean(-1)
    x0, x1, y0, y1 = light_region(camera, [(147.5, 554.9, 172.5), (407.5, 554.9, 172.5),
                                           (147.5, 554.9, 382.5), (407.5, 554.9, 382.5)])
    lit = lum[y0:y1 + 1, x0:x1 + 1]
    p99 = np.percentile(lum, 99.0)
    log(f"light region px [{x0},{x1}]x[{y0},{y1}]: median {np.median(lit):.3f}, "
        f"image p99 {p99:.3f}, image mean {lum.mean():.4f}")
    if not (lit.size > 0 and np.median(lit) >= p99):
        raise AssertionError("the light's pixels are not the brightest")
    return hdr


# ---------------------------------------------------------------- wavefront

def record_steps(renderer, fn_module, fn_name):
    """Render through the main path with the traversal inputs (org, dirn,
    t_max) of every pool step recorded (on the card).  Returns the list."""
    recorded = []
    launch = getattr(fn_module, fn_name)

    def record(pack, org, dirn, t_min, t_max, **kw):
        recorded.append((org.clone(), dirn.clone(), t_max.clone()))
        return launch(pack, org, dirn, t_min, t_max, **kw)

    setattr(fn_module, fn_name, record)
    try:
        renderer.render(mode="pool")
    finally:
        setattr(fn_module, fn_name, launch)
    return recorded


def pick_steps(recorded):
    """(tag, index) of the first step that traces rays (primary rays: the
    pool starts with every lane dead), a mid-render step and a drain step
    (the first step past the middle with fewer than half the lanes live)."""
    live = [float((t_max != 0).float().mean()) for _, _, t_max in recorded]
    first = next(k for k, x in enumerate(live) if x > 0)
    mid = len(recorded) // 2
    drain = next((k for k in range(mid + 1, len(recorded)) if live[k] < 0.5),
                 len(recorded) - 1)
    return [("first", first), ("mid", mid), ("drain", drain)], live


def hold_vs_exact(pack, org, dirn, t_max, t, slot, dropped, tag):
    """The wavefront result (t, slot) against the BVH8 kernel's on the same
    rays.  On lanes of packets that did not overflow: hit masks equal, t
    within rtol 2e-5 / atol 1e-6, slot agreement >= 0.999.  On packets that
    overflowed: no hit the exact walk lacks, none nearer than its.
    Returns (max |dt| on non-overflowed hits, slot agreement)."""
    from rust_raytracer_torch.ops import bvh8

    t_e, i_e = bvh8.intersect_triangles_bvh8(pack, org, dirn, None, t_max)
    lane_drop = dropped.repeat_interleave(8)[:org.shape[0]]
    keep = ~lane_drop
    hw, he = slot >= 0, i_e >= 0
    if not torch.equal(hw[keep], he[keep]):
        bad = int((hw[keep] != he[keep]).sum())
        raise AssertionError(f"{tag}: hit masks differ from the BVH8 kernel on {bad} "
                             f"lanes of packets that did not overflow")
    both = keep & hw
    err = (t[both] - t_e[both]).abs()
    if both.any() and not torch.all(err <= 1e-6 + 2e-5 * t_e[both].abs()):
        raise AssertionError(f"{tag}: t differs from the BVH8 kernel, max {err.max().item()}")
    agree = (slot[both] == i_e[both]).float().mean().item() if both.any() else 1.0
    if agree < 0.999:
        raise AssertionError(f"{tag}: slot agreement with the BVH8 kernel {agree} < 0.999")
    if (lane_drop & hw & ~he).any():
        raise AssertionError(f"{tag}: an overflowed packet reports a hit the exact walk lacks")
    od = lane_drop & hw & he
    if (t[od] < t_e[od]).any():
        raise AssertionError(f"{tag}: an overflowed packet reports a hit nearer than exact")
    if not torch.equal(t[~hw], t_max[~hw]):
        raise AssertionError(f"{tag}: missed rays do not return t_max")
    return (err.max().item() if both.any() else 0.0), agree


def wf_stage_parity(pack, org, dirn, t_max, tag):
    """Each wavefront kernel against its plain version on the same inputs
    (A: keys and counts equal; L2: rows and totals equal; MT: max |dt| 0,
    slots equal; overflow counts equal), then the kernel pipeline against
    the BVH8 kernel.  Returns a dict of what was measured."""
    from rust_raytracer_torch.ops import wavefront as wf

    S = pack.wf_sn_lo.shape[0]
    k1 = min(wf.K1, -(-S // 8) * 8)
    kc = wf.KC
    k = min(wf.PAIRS_PER_PACKET_CAP, k1 * kc)
    tm = torch.clamp(t_max, max=wf.BIG)
    sn_slot, l1_cnt = wf.nearest_boxes(pack.wf_sn_lo, pack.wf_sn_hi, org, dirn, t_max, k1)
    n1 = torch.clamp(l1_cnt, max=k1)
    a_in = (sn_slot, n1, pack.wf_sn_start, pack.wf_sn_bounds, org, dirn, tm, kc)
    keys, counts = wf.cull(*a_in)
    keys_p, counts_p = wf.cull_plain(*a_in)
    if not (torch.equal(keys, keys_p) and torch.equal(counts, counts_p)):
        raise AssertionError(f"{tag}: wf_cull differs from its plain version")
    cl, real = wf.compact(keys, counts, n1, k)
    cl_p, real_p = wf.compact_plain(keys, counts, n1, k)
    if not (torch.equal(cl, cl_p) and torch.equal(real, real_p)):
        raise AssertionError(f"{tag}: wf_compact differs from its plain version")
    cnt = torch.clamp(real, max=k)
    t, slot = wf.mt(cl, cnt, org, dirn, tm, pack.tri_rows)
    t_p, slot_p = wf.mt_plain(cl, cnt, org, dirn, tm, pack.tri_rows)
    torch.cuda.synchronize()
    mt_err = (t - t_p).abs().max().item()
    if not (mt_err == 0 and torch.equal(slot, slot_p)):
        raise AssertionError(f"{tag}: wf_mt differs from its plain version "
                             f"(max |dt| {mt_err}, slots equal {torch.equal(slot, slot_p)})")
    dropped = wf.overflowed(l1_cnt, counts, real, k1, kc, k)
    if not torch.equal(dropped, wf.overflowed(l1_cnt, counts_p, real_p, k1, kc, k)):
        raise AssertionError(f"{tag}: overflow counts differ between kernels and plain")
    t = torch.where(slot < 0, t_max, t)
    exact_err, agree = hold_vs_exact(pack, org, dirn, t_max, t, slot, dropped, tag)
    out = dict(mt_err=mt_err, exact_err=exact_err, agree=agree,
               overflow=int(dropped.sum()), packets=dropped.numel(),
               hits=int((slot >= 0).sum()), live=int((t_max != 0).sum()),
               pairs=int(cnt.sum()), l1=float(n1.float().mean()))
    log(f"wavefront parity {tag}: {org.shape[0]} rays ({out['live']} live), A/L2 equal, "
        f"MT max |dt| {mt_err:.3e} slots equal; vs BVH8 kernel: hits {out['hits']}, "
        f"max |dt| {exact_err:.3e}, slot agreement {agree:.6f}; overflow "
        f"{out['overflow']}/{out['packets']} packets ({out['overflow'] / out['packets']:.4%}), "
        f"mean supernodes {out['l1']:.2f}, candidate pairs {out['pairs']}")
    return out


def dense_parity(pack, org, dirn, t_max):
    """The dense single-level pipeline (cull and top k in torch ops, then
    MT) on these rays: MT kernel against its plain version, the pipeline
    against the BVH8 kernel."""
    from rust_raytracer_torch.ops import wavefront as wf

    k = min(wf.PAIRS_PER_PACKET_CAP, pack.wf_cl_lo.shape[0])
    t, slot, dropped = wf.pipeline(pack.wf_cl_lo, pack.wf_cl_hi, pack.tri_rows,
                                   org, dirn, t_max)
    cl, pk_cnt = wf.nearest_boxes(pack.wf_cl_lo, pack.wf_cl_hi, org, dirn, t_max, k)
    t_p, slot_p = wf.mt_plain(cl, torch.clamp(pk_cnt, max=k), org, dirn,
                              torch.clamp(t_max, max=wf.BIG), pack.tri_rows)
    torch.cuda.synchronize()
    err = (t - t_p).abs().max().item()
    if not (err == 0 and torch.equal(slot, slot_p)):
        raise AssertionError(f"dense: wf_mt differs from its plain version ({err})")
    t = torch.where(slot < 0, t_max, t)
    exact_err, agree = hold_vs_exact(pack, org, dirn, t_max, t, slot, dropped, "dense")
    log(f"wavefront dense pipeline: {org.shape[0]} rays, {pack.wf_cl_lo.shape[0]} "
        f"clusters, k {k}: MT max |dt| {err:.3e} slots equal; vs BVH8 kernel: hits "
        f"{int((slot >= 0).sum())}, max |dt| {exact_err:.3e}, slot agreement {agree:.6f}, "
        f"overflow {int(dropped.sum())}/{dropped.numel()} packets")
    return err


def wf_times(pack, org, dirn, t_max, card):
    """Each wavefront kernel and its plain version on the same inputs
    (median of 5, host clock around a synchronized call)."""
    from rust_raytracer_torch.ops import wavefront as wf

    S = pack.wf_sn_lo.shape[0]
    k1 = min(wf.K1, -(-S // 8) * 8)
    k = min(wf.PAIRS_PER_PACKET_CAP, k1 * wf.KC)
    tm = torch.clamp(t_max, max=wf.BIG)
    sn_slot, l1_cnt = wf.nearest_boxes(pack.wf_sn_lo, pack.wf_sn_hi, org, dirn, t_max, k1)
    n1 = torch.clamp(l1_cnt, max=k1)
    a_in = (sn_slot, n1, pack.wf_sn_start, pack.wf_sn_bounds, org, dirn, tm, wf.KC)
    keys, counts = wf.cull(*a_in)
    cl, real = wf.compact(keys, counts, n1, k)
    mt_in = (cl, torch.clamp(real, max=k), org, dirn, tm, pack.tri_rows)
    times = {
        "l1": (time_ms(lambda: wf.nearest_boxes(pack.wf_sn_lo, pack.wf_sn_hi, org, dirn,
                                                t_max, k1)), None),
        "wf_cull": (time_ms(lambda: wf.cull(*a_in)), time_ms(lambda: wf.cull_plain(*a_in))),
        "wf_compact": (time_ms(lambda: wf.compact(keys, counts, n1, k)),
                       time_ms(lambda: wf.compact_plain(keys, counts, n1, k))),
        "wf_mt": (time_ms(lambda: wf.mt(*mt_in)), time_ms(lambda: wf.mt_plain(*mt_in))),
    }
    log(f"time wavefront mid-render step x{org.shape[0]}: L1 (torch ops) "
        f"{times['l1'][0]:.3f} ms; " + "; ".join(
            f"{nm} kernel {times[nm][0]:.3f} ms, plain {times[nm][1]:.3f} ms"
            for nm in ("wf_cull", "wf_compact", "wf_mt")) + f" (median of 5; {card})")
    return times


def image_agreement(a, b):
    """bench.py's image parity, per pixel: the share of pixels with every
    channel within 1e-3 * mean(b) + 1e-3 * |b|, and mean |a - b| / mean(b)."""
    scale = max(float(np.mean(b)), 1e-6)
    off = np.any(np.abs(a - b) > 1e-3 * scale + 1e-3 * np.abs(b), axis=-1)
    return 1.0 - float(off.mean()), float(np.mean(np.abs(a - b))) / scale


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs a CUDA GPU")
    sys.path.insert(0, HERE)
    from rust_raytracer_tpu import models, native
    from rust_raytracer_tpu.models import builtin
    from rust_raytracer_tpu.scene import graph as g
    from rust_raytracer_tpu.utils import config as cfg
    from rust_raytracer_tpu.utils import procgen
    from rust_raytracer_torch.core import rng as vrng
    from rust_raytracer_torch.ops import bvh8
    from rust_raytracer_torch.ops import wavefront as wf
    from rust_raytracer_torch.render import integrator
    from rust_raytracer_torch.render.camera import camera_from_config
    from rust_raytracer_torch.render.pool import PoolMetrics
    from rust_raytracer_torch.render.renderer import Renderer
    from rust_raytracer_torch.scene import compiler

    dev = torch.device("cuda:0")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- 1. build the kernel library from the checkout's sources ----
    t0 = time.perf_counter()
    lib = bvh8.build_library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib, HERE)}")

    # the RNG's int64 arithmetic on the card equals the CPU's bit for bit
    q = np.random.default_rng(1).integers(0, 2**32, size=(4, 4096), dtype=np.int64)
    q[:, :4] = np.array([0, 2**31, 2**32 - 1, 2**32 - 128])[None]
    cpu_bits = vrng.random_bits4(*(torch.from_numpy(x) for x in q))
    gpu_bits = vrng.random_bits4(*(torch.from_numpy(x).to(dev) for x in q))
    for on_cpu, on_gpu in zip(cpu_bits, gpu_bits):
        if not torch.equal(on_cpu, on_gpu.cpu()):
            raise AssertionError("pcg4d on the card differs from the CPU")
    log("rng: pcg4d on the card equals the CPU bit for bit")

    # ---- 2. the full cornell_dragon scene on the card ----
    t0 = time.perf_counter()
    scene = models.build("cornell_dragon")
    scene_config = cfg.merge_scene_config(scene.config, {"output_width": W})
    camera = camera_from_config(
        scene_config, cfg.RenderConfig(samples_per_pixel=SPP, max_depth=DEPTH))
    pack, static = compiler.compile_scene(scene, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_slots = int(pack.tri_v0.shape[0])
    n_tris = int((pack.tri_rows[:, 3:9] != 0).any(dim=1).sum())
    log(f"scene cornell_dragon: {n_tris} triangles in {n_slots} slots, "
        f"{pack.tri_rows.shape[0] // 128} clusters, n8 {pack.bvh8_child.shape[0]}, "
        f"BVH8 depth {pack.bvh8_depth}, build {build_s:.2f} s, "
        f"native SAH builder: {native.available()}")

    # ---- 3. kernel against its plain version at the pool width, then both
    # timed on the same rays ----
    org, dirn = make_rays(camera, LANES, dev)
    err_p, _, _, (t_k, i_k) = compare(pack, org, dirn, "primary")
    org2, dirn2 = bounce_rays(org, dirn, t_k, i_k)
    err_b, _, _, (t_b, i_b) = compare(pack, org2, dirn2, "bounce")
    # t_max as the pool passes it: +inf (no sphere or plane in the way), 0
    # (dead lane), capped short of the triangle hit; 3.4e38 as bench.py's
    lane = torch.arange(LANES, device=dev)
    inf = torch.full_like(t_b, float("inf"))
    cap = torch.where(lane % 4 == 0, inf, torch.full_like(t_b, 3.4e38))
    cap = torch.where(lane % 4 == 1, torch.zeros_like(t_b), cap)
    cap = torch.where(lane % 4 == 3, torch.where(i_b >= 0, t_b * 0.5, inf), cap)
    err_c, _, _, (_, i_c) = compare(pack, org2, dirn2, "bounce +inf/capped/dead", cap)
    if (i_c[lane % 4 == 1] >= 0).any() or (i_c[lane % 4 == 3] >= 0).any():
        raise AssertionError("a dead or capped ray reported a hit beyond its t_max")
    if not torch.equal(i_c[lane % 4 == 0] >= 0, i_b[lane % 4 == 0] >= 0):
        raise AssertionError("t_max = +inf and 3.4e38 give different hits")
    max_err = max(err_p, err_b, err_c)

    t_max = torch.full((LANES,), 3.4e38, dtype=torch.float32, device=dev)
    times = {}
    for tag, (o, d) in (("primary", (org, dirn)), ("bounce", (org2, dirn2))):
        times[tag] = (
            time_ms(lambda: bvh8.intersect_triangles_bvh8(pack, o, d, None, t_max)),
            time_ms(lambda: bvh8.traverse_plain(pack, o, d, t_max)),
        )
        log(f"time {tag} rays x{LANES}: kernel {times[tag][0]:.3f} ms, "
            f"plain {times[tag][1]:.3f} ms (median of 5; {card})")
    del pack

    # ---- 4. a small render on the card agrees with the same on the CPU ----
    small_cfg = cfg.merge_scene_config(scene.config, {"output_width": 32})
    small_cam = camera_from_config(small_cfg, cfg.RenderConfig(samples_per_pixel=4, max_depth=8))
    mat_white, walls = builtin._cornell_shell()
    mat_gloss = g.Glossy(g.Constant((0.73, 0.73, 0.73)), g.Constant(0.0), 1.5)
    light = g.Plane((277.5, 554.9, 277.5), (-130, 0, 0), (0, 0, -105),
                    g.Emissive(g.Constant((15.0, 15.0, 15.0))), render_backface=True)
    knot = g.Transform(procgen.torus_knot_mesh(mat_gloss, rings=40, segments=12))
    knot.scale(110).rotate_y(225).translate(267.5, 200.0, 277.5)
    mini = g.SceneDef(
        world=g.Group([g.Plane((277.5, 0, 277.5), (277.5, 0, 0), (0, 0, -277.5), mat_white)]
                      + walls + [light, knot]),
        lights=[light], config=dict(scene.config))
    imgs = [Renderer(mini, small_cam, batch_size=1024, device=d).render().hdr()
            for d in (dev, "cpu")]
    rel = np.abs(imgs[0] - imgs[1]).mean() / imgs[1].mean()
    close = np.isclose(imgs[0], imgs[1], rtol=1e-3, atol=1e-4).mean()
    log(f"small render card vs cpu: mean |d|/mean {rel:.3e}, pixels close {close:.4f}")
    if not (rel <= 1e-3 and close >= 0.995):
        raise AssertionError("the card's render disagrees with the CPU's")

    # ---- 5. the main path: full-width pool render through the kernel ----
    renderer = Renderer(scene, camera, batch_size=LANES, kernel="auto", device=dev)
    metrics = PoolMetrics()
    torch.cuda.synchronize()
    bvh8.launches = 0
    bvh8.plain_calls = 0
    t0 = time.perf_counter()
    film = renderer.render(mode="pool", metrics=metrics)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches, plain_calls = bvh8.launches, bvh8.plain_calls
    if not (launches > 0 and launches == metrics.steps and plain_calls == 0):
        raise AssertionError(
            f"main path: {launches} kernel launches, {metrics.steps} pool steps, "
            f"{plain_calls} plain calls")
    hdr = check_image(film, camera)
    h = camera.image_height
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    film.save(os.path.join(HERE, "build", "chip_smoke_cornell_dragon.png"))
    total = W * h * SPP
    log(f"main path: cornell_dragon {W}x{h}@{SPP}spp depth {DEPTH}, {LANES} lanes: "
        f"{total / render_s:.1f} pixel-samples/s ({render_s:.3f} s), "
        f"{metrics.steps} steps, mean occupancy {metrics.mean_occupancy:.4f}, "
        f"kernel launches {launches} ({card})")

    # ---- 6. the kernel against its plain version on every pool step's own
    # inputs ----
    max_err = max(max_err, pool_step_parity(renderer))

    # ---- 7. where a steady pool step's device time goes ----
    step_split(renderer, camera, card, ("bvh8_traverse",))

    # ---- 8. wavefront: each kernel against its plain version, and the
    # pipeline against the BVH8 kernel, on the traversal inputs of a
    # kernel="wavefront" render at its first, a mid-render and a drain step ----
    wf_renderer = Renderer(scene, camera, batch_size=LANES, kernel="wavefront", device=dev)
    wpack = wf_renderer.pack
    log(f"wavefront tables: {wpack.wf_cl_lo.shape[0]} clusters, "
        f"{wpack.wf_sn_lo.shape[0]} supernodes, K1 {wf.K1}, KC {wf.KC}, "
        f"cap {wf.PAIRS_PER_PACKET_CAP}")
    recorded = record_steps(wf_renderer, wf, "intersect_triangles_wavefront")
    picks, live = pick_steps(recorded)
    log(f"recorded {len(recorded)} wavefront pool steps; live lane share per step: "
        + " ".join(f"{x:.3f}" for x in live))
    stage = {}
    for tag, k in picks:
        stage[tag] = wf_stage_parity(wpack, *recorded[k], f"{tag} (step {k + 1})")
    # the pool's first rays cover the top image rows, which hold no
    # triangle: also primary rays over the whole image, in the pool's
    # compaction order, with t_max = +inf
    org, dirn = make_rays(camera, LANES, dev)
    alive = torch.ones((LANES,), dtype=torch.bool, device=dev)
    perm = torch.sort(integrator._compaction_key(org, dirn, alive), stable=True).indices
    stage["primary"] = wf_stage_parity(
        wpack, org[perm].contiguous(), dirn[perm].contiguous(),
        torch.full((LANES,), float("inf"), device=dev), "primary (whole image)")
    mid = recorded[picks[1][1]]
    del recorded

    # ---- 9. the dense single-level pipeline on 2^15 lanes of the mid step
    # (cornell_dragon's dispatch takes the two-level one) ----
    n_dense = 1 << 15
    dense_err = dense_parity(wpack, *(a[:n_dense].contiguous() for a in mid))

    # ---- 10. each wavefront kernel's time against its plain version's ----
    wf_time = wf_times(wpack, *mid, card)
    del mid

    # ---- 11. the wavefront main path ----
    wf_metrics = PoolMetrics()
    torch.cuda.synchronize()
    bvh8.launches, bvh8.plain_calls = 0, 0
    for name in wf.KERNELS:
        wf.launches[name], wf.plain_calls[name] = 0, 0
    t0 = time.perf_counter()
    wf_film = wf_renderer.render(mode="pool", metrics=wf_metrics)
    torch.cuda.synchronize()
    wf_render_s = time.perf_counter() - t0
    wf_launches = dict(wf.launches)
    if not (all(n == wf_metrics.steps > 0 for n in wf_launches.values())
            and bvh8.launches == 0 and bvh8.plain_calls == 0
            and not any(wf.plain_calls.values())):
        raise AssertionError(
            f"wavefront main path: launches {wf_launches}, {wf_metrics.steps} pool steps, "
            f"plain calls {wf.plain_calls}, BVH8 launches {bvh8.launches}, "
            f"BVH8 plain calls {bvh8.plain_calls}")
    wf_hdr = check_image(wf_film, camera)
    wf_film.save(os.path.join(HERE, "build", "chip_smoke_cornell_dragon_wavefront.png"))
    ov_frac = wf_metrics.overflow / wf_metrics.total_packets
    log(f"wavefront main path: cornell_dragon {W}x{h}@{SPP}spp depth {DEPTH}, {LANES} "
        f"lanes: {total / wf_render_s:.1f} pixel-samples/s ({wf_render_s:.3f} s; BVH8 "
        f"path above {total / render_s:.1f}), {wf_metrics.steps} steps, mean occupancy "
        f"{wf_metrics.mean_occupancy:.4f}, launches {wf_launches}, overflow "
        f"{wf_metrics.overflow}/{wf_metrics.total_packets} packets ({ov_frac:.4%}) ({card})")
    agree, rel = image_agreement(wf_hdr, hdr)
    log(f"wavefront image vs BVH8 image: pixel agreement {agree:.6f}, "
        f"mean |d|/mean {rel:.3e}")
    if not (agree >= 0.99 and rel <= 1e-2):
        raise AssertionError("the wavefront render disagrees with the BVH8 render")

    # ---- 12. where a steady wavefront pool step's device time goes ----
    step_split(wf_renderer, camera, card, ("wf_cull_kernel", "wf_compact_kernel",
                                           "wf_mt_kernel"))

    if "jax" in sys.modules and sys.modules["jax"] is not None:
        raise AssertionError("jax was imported")
    wf_err = {"wf_cull": 0, "wf_compact": 0,
              "wf_mt": max([dense_err] + [st["mt_err"] for st in stage.values()])}
    replaces = {"wf_cull": 302, "wf_compact": 386, "wf_mt": 108}
    log(json.dumps({"kernels": [{
        "name": "bvh8_traverse",
        "route": "cuda",
        "source": "rust_raytracer_torch/csrc/bvh8_traverse.cu",
        "replaces": "rust_raytracer_tpu/ops/pallas_bvh8.py:63",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["bounce"][0],
        "plain_ms": times["bounce"][1],
        "ms_primary": times["primary"][0],
        "plain_ms_primary": times["primary"][1],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"rust_raytracer_torch/csrc/{name}.cu",
        "replaces": f"rust_raytracer_tpu/ops/pallas_wavefront.py:{replaces[name]}",
        "launches": wf_launches[name],
        "max_abs_err": wf_err[name],
        "ms": wf_time[name][0],
        "plain_ms": wf_time[name][1],
    } for name in wf.KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
