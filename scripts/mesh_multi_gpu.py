"""The mesh across processes, one GPU each: parallel/mesh.py's nccl path.

    python3 scripts/mesh_multi_gpu.py                 # every CUDA device, one process each
    python3 scripts/mesh_multi_gpu.py --device cpu --procs 4 --small   # gloo rehearsal

Starts one process a device, joined by init_multihost (nccl on CUDA, gloo
on the CPU) into one mesh of that many shards, and in each: builds
cornell_dragon (the main path's scene) on its device, renders it at
1200x1200, 4 spp, depth 20 through the sharded pool with 2^18 lanes a
shard (K1), traces 2^18 lanes of primary rays through shard_batch_fn, and
takes one train_step_fn step of 2^15 lanes, depth 20, through K3.  Rank 0
then runs the same on its own GPU alone (the pool with 2^18 lanes, the
batch unsharded, the step on a one-shard mesh) and holds the mesh's
results against it: the image within float sum order (mean |d| / mean
<= 1e-6), every lane's radiance bit for bit, loss and gradients / shards
within 1e-5 of the largest entry.  Each side runs twice and is timed on
its second run (the first builds the kernels and warms the device).  It
prints each rate, the pool's steps
and K1 launches on every rank, and a JSON line of it all.  --small renders
the "test" scene at 32x32 with 256 lanes a shard, for a rehearsal on the
CPU.

Each worker is killed at its timeout; any failed check or worker raises,
so the exit code is non-zero.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.modules["jax"] = None  # the port runs without JAX

import torch  # noqa: E402

TIMEOUT = 900


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def config(small):
    from rust_raytracer_torch import models
    from rust_raytracer_torch.render.camera import camera_from_config
    from rust_raytracer_torch.utils import config as cfg

    name, width, spp, lanes, batch, grad = (("test", 32, 4, 256, 1024, 256) if small else
                                            ("cornell_dragon", 1200, 4, 1 << 18, 1 << 18, 1 << 15))
    scene = models.build(name)
    cam = camera_from_config(cfg.merge_scene_config(scene.config, {"output_width": width}),
                             cfg.RenderConfig(samples_per_pixel=spp, max_depth=20))
    return scene, cam, lanes, batch, grad


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def work(pack, static, cam, dev, mesh, lanes, batch, grad):
    """The pool, the batch and the train step on `mesh`: (accum, stats,
    radiance, loss, grads)."""
    import torch.distributed as dist

    from rust_raytracer_torch.core import rng as vrng
    from rust_raytracer_torch.ops import bvh8, threaded
    from rust_raytracer_torch.parallel import mesh as pmesh
    from rust_raytracer_torch.render import integrator
    from rust_raytracer_torch.render import pool as poolmod
    from rust_raytracer_torch.utils.metrics import RenderMetrics

    def barrier():
        sync(dev)
        if mesh.multiprocess:
            dist.barrier()

    n_pixels = cam.image_width * cam.image_height
    spp = cam.actual_spp
    stats = {}
    m = RenderMetrics()
    bvh8.launches = 0
    barrier()
    t0 = time.perf_counter()
    accum = poolmod.render_pool(pack, static, cam, n_pixels, spp, lanes * mesh.n_shards, dev,
                                metrics=m, mesh=mesh)
    barrier()
    stats["pool_s"] = time.perf_counter() - t0
    stats["pool_steps"], stats["k1_launches"] = m.steps, bvh8.launches

    # lanes spread evenly over the image's (pixel, sample) grid
    flat = torch.arange(batch, device=dev) * (n_pixels * spp // batch)
    pix, smp = flat // spp, flat % spp
    px, py = pix % cam.image_width, pix // cam.image_width

    def batch_fn(p, px, py, sample, seed, differentiable=False, kernel="auto"):
        ctx = vrng.Ctx(pixel=py * cam.image_width + px, sample=sample, bounce=0, seed=seed)
        org, dirn = cam.generate_rays(px, py, sample, ctx)
        return integrator.trace(p, static, org, dirn, ctx, cam.max_depth, cam.light_bias,
                                compact=not differentiable, differentiable=differentiable,
                                kernel=kernel)

    barrier()
    t0 = time.perf_counter()
    rad = pmesh.shard_batch_fn(batch_fn, mesh)(pack, px, py, smp, 0)
    barrier()
    stats["batch_s"] = time.perf_counter() - t0

    step = pmesh.train_step_fn(
        lambda *a: batch_fn(*a, differentiable=True, kernel="threaded"),
        lambda r, t: (r ** 2).mean(), mesh, kernel="threaded")
    threaded.launches = 0
    barrier()
    t0 = time.perf_counter()
    every = batch // grad
    loss, grads = step(pack, px[::every], py[::every], smp[::every], 0,
                       torch.zeros((grad, 3), device=dev))
    barrier()
    stats["step_s"] = time.perf_counter() - t0
    stats["k3_launches"] = threaded.launches
    return accum, stats, rad, loss, grads


def worker(rank, n, addr, device, small):
    from rust_raytracer_torch.parallel import mesh as pmesh
    from rust_raytracer_torch.scene import compiler

    if device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    pmesh.init_multihost(addr, n, rank, device=device)
    import torch.distributed as dist

    try:
        mesh = pmesh.make_mesh(n, device=device)
        if mesh.devices != (dev,) or mesh.first != rank:
            raise AssertionError(f"rank {rank}: unexpected mesh {mesh}")
        scene, cam, lanes, batch, grad = config(small)
        pack, static = compiler.compile_scene(scene, dev)
        # each side runs twice and keeps its second, warm, reading: the first
        # builds the kernels and warms the device, the allocator and autograd
        for _ in range(2):
            accum, stats, rad, loss, grads = work(pack, static, cam, dev, mesh, lanes, batch,
                                                  grad)
        keys = sorted(stats)
        per_rank = pmesh.all_gather_cat(
            mesh, torch.tensor([[float(stats[k]) for k in keys]], dtype=torch.float64,
                               device=dev)).cpu().tolist()
        if rank == 0:
            alone = pmesh.Mesh(devices=(dev,), n_shards=1)
            for _ in range(2):
                a_accum, a_stats, a_rad, a_loss, a_grads = work(pack, static, cam, dev, alone,
                                                                lanes, batch, grad)
            report(n, device, cam, lanes, batch, grad, keys, per_rank, accum, rad, loss, grads,
                   a_accum, a_stats, a_rad, a_loss, a_grads, pack.float_fields())
    finally:
        dist.destroy_process_group()


def report(n, device, cam, lanes, batch, grad, keys, per_rank, accum, rad, loss, grads,
           a_accum, a_stats, a_rad, a_loss, a_grads, fields):
    card = card_line() if device == "cuda" else "cpu"
    total = cam.image_width * cam.image_height * cam.actual_spp
    img_rel = float((accum - a_accum).abs().mean() / a_accum.abs().mean())
    lanes_differ = int((rad != a_rad).any(dim=1).sum())
    loss_gap = abs(float(loss) / n - float(a_loss)) / max(abs(float(a_loss)), 1e-30)
    grad_gap = 0.0
    for g, a in zip(grads, a_grads):
        if a.numel() and float(a.abs().max()) > 0:
            grad_gap = max(grad_gap, float((g / n - a).abs().max() / a.abs().max()))
    ranks = [dict(zip(keys, r)) for r in per_rank]
    pool_s = max(r["pool_s"] for r in ranks)
    out = {
        "device": device, "processes": n, "card": card,
        "pool": {"pixel_samples": total, "lanes_a_shard": lanes,
                 "mesh_pixel_samples_per_s": total / pool_s,
                 "one_gpu_pixel_samples_per_s": total / a_stats["pool_s"],
                 "steps_by_rank": [int(r["pool_steps"]) for r in ranks],
                 "k1_launches_by_rank": [int(r["k1_launches"]) for r in ranks],
                 "one_gpu_steps": a_stats["pool_steps"], "image_mean_rel": img_rel},
        "batch": {"lanes": batch, "mesh_s": max(r["batch_s"] for r in ranks),
                  "one_gpu_s": a_stats["batch_s"], "lanes_not_bit_equal": lanes_differ},
        "train_step": {"lanes": grad, "mesh_s": max(r["step_s"] for r in ranks),
                       "one_gpu_s": a_stats["step_s"],
                       "k3_launches_by_rank": [int(r["k3_launches"]) for r in ranks],
                       "loss_gap": loss_gap, "grad_gap": grad_gap, "tables": len(fields)},
    }
    p = out["pool"]
    print(f"mesh of {n} processes ({device}, {card}): pool {total} pixel-samples at "
          f"{lanes} lanes a shard: {p['mesh_pixel_samples_per_s']:.1f} pixel-samples/s against "
          f"{p['one_gpu_pixel_samples_per_s']:.1f} on one device alone "
          f"({p['mesh_pixel_samples_per_s'] / p['one_gpu_pixel_samples_per_s']:.3f}x), steps "
          f"{p['steps_by_rank']} (alone {p['one_gpu_steps']}), K1 launches "
          f"{p['k1_launches_by_rank']}; image mean |d|/mean {img_rel:.3e}", flush=True)
    print(f"batch of {batch} lanes: {out['batch']['mesh_s'] * 1e3:.1f} ms on the mesh, "
          f"{out['batch']['one_gpu_s'] * 1e3:.1f} ms alone; {lanes_differ} lanes not bit-equal; "
          f"train_step_fn of {grad} lanes: {out['train_step']['mesh_s'] * 1e3:.1f} ms on the mesh, "
          f"{out['train_step']['one_gpu_s'] * 1e3:.1f} ms alone, K3 launches "
          f"{out['train_step']['k3_launches_by_rank']}; loss gap {loss_gap:.3e}, gradients "
          f"max |d|/max |g| {grad_gap:.3e} ({card})", flush=True)
    print(json.dumps(out), flush=True)
    if not float(a_loss) > 0:
        raise AssertionError("the train step's loss is 0: its lanes see nothing")
    # the CPU runs the plain walks: kernel launches only on CUDA
    launched = device == "cpu" or all(
        k == s for k, s in zip(p["k1_launches_by_rank"], p["steps_by_rank"]))
    if not (img_rel <= 1e-6 and lanes_differ == 0 and loss_gap <= 1e-5 and grad_gap <= 1e-5
            and launched):
        raise AssertionError("the mesh's results disagree with one device's")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--procs", type=int, default=None)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--worker", nargs=2, metavar=("RANK", "ADDR"))
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("mesh_multi_gpu: torch.cuda.is_available() is False")
    n = args.procs or (torch.cuda.device_count() if args.device == "cuda" else 4)
    if args.worker:
        return worker(int(args.worker[0]), n, args.worker[1], args.device, args.small)
    if n < 2:
        raise SystemExit(f"mesh_multi_gpu: needs 2 or more processes, got {n}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    cmd = [sys.executable, os.path.abspath(__file__), "--device", args.device,
           "--procs", str(n)] + (["--small"] if args.small else [])
    procs = [subprocess.Popen(cmd + ["--worker", str(r), addr]) for r in range(n)]
    deadline = time.time() + TIMEOUT
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.time())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs) or len(rcs) < n:
        raise SystemExit(f"mesh_multi_gpu: worker exit codes {rcs}")


if __name__ == "__main__":
    main()
