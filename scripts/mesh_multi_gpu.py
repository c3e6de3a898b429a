"""The mesh over several GPUs, warm: the sharded pool, the batch program and
train_step_fn, each against one GPU alone in the same call.

    python3 scripts/mesh_multi_gpu.py --mode process   # one process: make_mesh(k), k = 1, 2, 4, ...
    python3 scripts/mesh_multi_gpu.py --mode nccl      # one nccl process a GPU: 2, then 4, ... GPUs
    python3 scripts/mesh_multi_gpu.py --mode process --device cpu --small         # rehearsals
    python3 scripts/mesh_multi_gpu.py --mode nccl --device cpu --small --procs 2  # on the CPU
    python3 scripts/mesh_multi_gpu.py --mode process --root chipcheck/parent      # another checkout

--mode process runs one process over parallel/mesh.py's make_mesh(k) for
k = 1, 2, 4, ... up to the device count (one shard a GPU); --mode nccl
starts one process a GPU, joined by init_multihost (nccl on CUDA, gloo on
the CPU), for 2, 4, ... processes up to the device count, or --procs of
them.  On each mesh, one Renderer of cornell_dragon (the main path's
scene, built once) renders it at 1200x1200, depth 20: the pool at 4 spp
(--spp) with 2^18 lanes a shard through K1, and the batch program at 1 spp in
batches of 2^18 lanes through K3 (render(mode="batch"), as
scripts/mesh_batch_program.py); then train_step_fn takes a step of 2^15
lanes, depth 20, through K3.  The same runs on the first GPU alone: the
unsharded pool at 2^18 lanes, the unsharded batch render, the step on a
one-shard mesh, and (process mode) the step at one shard's share of the
lanes, which a mesh whose shards overlap should take as long as.  Each
render and step runs twice on the same Renderer and step, and is timed on
its second, warm run (the first builds the kernels and captures the
graphs).  Checks: the pool image against the alone one within float sum
order (mean |d| / mean <= 1e-6), the batch image bit for bit, the loss and
gradients / shards within 1e-5 of the largest entry, and on CUDA the K1
launches equal to shards x steps on every process.  It prints the card
line, a line a mesh and one JSON line a mesh, `{"mesh_multi_gpu": ...}`
(the mode, the shard count, each time or rate beside one GPU's alone, the
card line).  --small renders the "test" scene at 32x32 with 256 lanes a
shard, for a rehearsal on the CPU.  --root imports the port from another
checkout (a parent commit unpacked beside this one), so two versions can
be compared in one call.

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
sys.modules["jax"] = None  # the port runs without JAX

import torch  # noqa: E402

TIMEOUT = 270


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def sync():
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def config(small, spp=4):
    """(scene, camera of the pool at `spp`, lanes a shard, batch, train-step
    lanes)."""
    from rust_raytracer_torch import models
    from rust_raytracer_torch.render.camera import camera_from_config
    from rust_raytracer_torch.utils import config as cfg

    name, width, lanes, batch, grad = (("test", 32, 256, 1024, 256) if small else
                                       ("cornell_dragon", 1200, 1 << 18, 1 << 18, 1 << 15))
    scene = models.build(name)
    cam = camera_from_config(cfg.merge_scene_config(scene.config, {"output_width": width}),
                             cfg.RenderConfig(samples_per_pixel=spp, max_depth=20))
    return scene, cam, lanes, batch, grad


class Bench:
    """One Renderer of the scene on `dev` and the train step's lanes."""

    def __init__(self, dev, small, spp, multiprocess=False):
        from rust_raytracer_torch.render.renderer import Renderer

        self.dev, self.multiprocess = dev, multiprocess
        scene, self.cam, self.lanes, self.batch, self.grad = config(small, spp)
        self.r = Renderer(scene, self.cam, batch_size=self.lanes, device=dev)
        cam = self.cam
        n_pixels, spp = cam.image_width * cam.image_height, cam.actual_spp
        # train-step lanes spread evenly over the image's (pixel, sample) grid
        flat = torch.arange(self.grad, device=dev) * (n_pixels * spp // self.grad)
        pix = flat // spp
        self.lanes_of_step = (pix % cam.image_width, pix // cam.image_width, flat % spp)

    def batch_fn(self, p, px, py, sample, seed):
        from rust_raytracer_torch.core import rng as vrng
        from rust_raytracer_torch.render import integrator

        cam = self.cam
        ctx = vrng.Ctx(pixel=py * cam.image_width + px, sample=sample, bounce=0, seed=seed)
        org, dirn = cam.generate_rays(px, py, sample, ctx)
        return integrator.trace(p, self.r.static, org, dirn, ctx, cam.max_depth,
                                cam.light_bias, compact=False, differentiable=True,
                                kernel="threaded")

    def barrier(self):
        sync()
        if self.multiprocess:
            import torch.distributed as dist

            dist.barrier()

    def timed(self, fn):
        """fn() twice; (its second result, the second run's seconds)."""
        for _ in range(2):
            self.barrier()
            t0 = time.perf_counter()
            out = fn()
            self.barrier()
        return out, time.perf_counter() - t0

    def pool(self, mesh):
        """The pool image over `mesh` (None: unsharded) at self.lanes lanes a
        shard; (image, {pool_s, pool_steps, k1_launches})."""
        from rust_raytracer_torch.ops import bvh8
        from rust_raytracer_torch.utils.metrics import RenderMetrics

        r, m = self.r, [None]
        r.mesh, r.kernel = mesh, "auto"
        r.batch_size = self.lanes * (1 if mesh is None else mesh.n_shards)

        def render():
            m[0] = RenderMetrics()
            bvh8.launches = 0
            return r.render(mode="pool", metrics=m[0]).hdr()

        img, secs = self.timed(render)
        return img, {"pool_s": secs, "pool_steps": m[0].steps, "k1_launches": bvh8.launches}

    def batch_render(self, mesh):
        """The batch program's image at 1 spp over `mesh`; (image, seconds)."""
        r = self.r
        r.mesh, r.kernel, r.batch_size = mesh, "threaded", self.batch
        try:
            return self.timed(lambda: r.render(mode="batch", spp=1).hdr())
        finally:
            r.kernel = "auto"

    def train_step(self, mesh, grad_lanes=None):
        """train_step_fn over `mesh` at `grad_lanes` lanes (every train-step
        lane by default); ((loss, grads), seconds, K3 launches)."""
        from rust_raytracer_torch.ops import threaded
        from rust_raytracer_torch.parallel import mesh as pmesh

        grad_lanes = grad_lanes or self.grad
        every = self.grad // grad_lanes
        px, py, smp = (t[::every] for t in self.lanes_of_step)
        step = pmesh.train_step_fn(self.batch_fn, lambda rad, t: (rad ** 2).mean(), mesh,
                                   kernel="threaded")
        target = torch.zeros((grad_lanes, 3), device=self.dev)

        def one():
            threaded.launches = 0
            return step(self.r.pack, px, py, smp, 0, target)

        out, secs = self.timed(one)
        return out, secs, threaded.launches

    def run(self, mesh, step_mesh):
        """The pool and the batch render over `mesh` and the train step over
        `step_mesh`: ((pool image, batch image, loss, grads), seconds and
        counts of the second runs)."""
        pool, stats = self.pool(mesh)
        img, stats["batch_s"] = self.batch_render(mesh)
        (loss, grads), stats["step_s"], stats["k3_launches"] = self.train_step(step_mesh)
        return (pool, img, loss, grads), stats


def compare(bench, n, got, alone):
    """The mesh's results against one device's: a dict of the checks."""
    pool, img, loss, grads = got
    a_pool, a_img, a_loss, a_grads = alone
    loss_gap = abs(float(loss) / n - float(a_loss)) / max(abs(float(a_loss)), 1e-30)
    grad_gap = 0.0
    for g, a in zip(grads, a_grads):
        if a.numel() and float(a.abs().max()) > 0:
            grad_gap = max(grad_gap, float((g / n - a).abs().max() / a.abs().max()))
    cam = bench.cam
    return {
        "image_mean_rel": float(abs(pool - a_pool).mean() / abs(a_pool).mean()),
        "pixels_not_bit_equal": int((img != a_img).any(axis=-1).sum()),
        "loss_gap": loss_gap, "grad_gap": grad_gap,
        "pixel_samples": cam.image_width * cam.image_height * cam.actual_spp,
        "zero_loss": not float(a_loss) > 0,
    }


def report(mode, device, n, procs, bench, checks, by_rank, a_stats, shard_step_s=None):
    """Print the mesh's line and JSON line; raise if a check failed."""
    card = card_line() if device == "cuda" else "cpu"
    total = checks["pixel_samples"]
    pool_s = max(r["pool_s"] for r in by_rank)
    steps = [int(r["pool_steps"]) for r in by_rank]
    # lane-steps a second, mesh over alone: the step's own scaling, apart
    # from the steps the render's drain and poll granularity add
    lane_steps = (max(steps) * bench.lanes * n / pool_s) / (
        a_stats["pool_steps"] * bench.lanes / a_stats["pool_s"])
    k1 = [int(r["k1_launches"]) for r in by_rank]
    cam = bench.cam
    out = {
        "mode": mode, "device": device, "card": card, "processes": procs, "shards": n,
        "scene": "test" if cam.image_width == 32 else "cornell_dragon",
        "width": cam.image_width, "depth": cam.max_depth,
        "pool": {"spp": cam.actual_spp, "lanes_a_shard": bench.lanes,
                 "pixel_samples_per_s": total / pool_s,
                 "one_device": total / a_stats["pool_s"],
                 "ratio": a_stats["pool_s"] / pool_s, "lane_steps_ratio": lane_steps,
                 "steps_by_process": steps,
                 "one_device_steps": int(a_stats["pool_steps"]),
                 "k1_launches_by_process": k1, "image_mean_rel": checks["image_mean_rel"]},
        "batch": {"spp": 1, "lanes": bench.batch,
                  "ms": max(r["batch_s"] for r in by_rank) * 1e3,
                  "one_device": a_stats["batch_s"] * 1e3,
                  "pixels_not_bit_equal": checks["pixels_not_bit_equal"]},
        "train_step": {"lanes": bench.grad, "ms": max(r["step_s"] for r in by_rank) * 1e3,
                       "one_device": a_stats["step_s"] * 1e3,
                       "one_shard_share_alone_ms": (None if shard_step_s is None
                                                    else shard_step_s * 1e3),
                       "k3_launches_by_process": [int(r["k3_launches"]) for r in by_rank],
                       "loss_gap": checks["loss_gap"], "grad_gap": checks["grad_gap"]},
    }
    p, b, t = out["pool"], out["batch"], out["train_step"]
    print(f"{mode}, {n} shard(s) in {procs} process(es) ({device}, {card}): pool "
          f"{p['pixel_samples_per_s']:.1f} pixel-samples/s against {p['one_device']:.1f} on one "
          f"device alone ({p['ratio']:.3f}x; lane-steps a second {lane_steps:.3f}x), steps "
          f"{steps} (alone {p['one_device_steps']}), "
          f"K1 launches {k1}, image mean |d|/mean {p['image_mean_rel']:.3e}; batch program "
          f"{b['ms']:.1f} ms against {b['one_device']:.1f} alone, {b['pixels_not_bit_equal']} "
          f"pixels not bit-equal; train_step_fn {t['ms']:.1f} ms against {t['one_device']:.1f} "
          f"alone" + ("" if shard_step_s is None else
                      f" ({t['one_shard_share_alone_ms']:.1f} ms for one shard's "
                      f"{bench.grad // n} lanes alone)") +
          f", K3 launches {t['k3_launches_by_process']}, loss gap {t['loss_gap']:.3e}, "
          f"gradients max |d|/max |g| {t['grad_gap']:.3e}", flush=True)
    print(json.dumps({"mesh_multi_gpu": out}), flush=True)
    if checks["zero_loss"]:
        raise AssertionError("the train step's loss is 0: its lanes see nothing")
    # the CPU runs the plain walks: kernel launches only on CUDA
    launched = device == "cpu" or all(k == s * n // procs for k, s in zip(k1, steps))
    if not (p["image_mean_rel"] <= 1e-6 and b["pixels_not_bit_equal"] == 0
            and t["loss_gap"] <= 1e-5 and t["grad_gap"] <= 1e-5 and launched):
        raise AssertionError(f"the mesh of {n} shard(s) disagrees with one device")


def one_process(device, small, spp):
    """--mode process: make_mesh(k) in this process for k = 1, 2, 4, ..."""
    from rust_raytracer_torch.parallel import mesh as pmesh

    count = torch.cuda.device_count() if device == "cuda" else 4
    if device == "cpu":
        torch.set_num_threads(2)
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    if device == "cuda":
        torch.cuda.set_device(dev)
    bench = Bench(dev, small, spp)
    alone_mesh = pmesh.Mesh(devices=(dev,), n_shards=1)
    alone, a_stats = bench.run(None, alone_mesh)
    for k in [1 << i for i in range(count.bit_length())]:
        mesh = pmesh.make_mesh(k, device=device)
        got, stats = bench.run(mesh, mesh)
        shard_s = bench.train_step(alone_mesh, bench.grad // k)[1] if k > 1 else None
        report("process", device, k, 1, bench, compare(bench, k, got, alone), [stats],
               a_stats, shard_s)


def worker(rank, n, addr, device, small, spp):
    """--mode nccl: one of n processes, one shard each."""
    from rust_raytracer_torch.parallel import mesh as pmesh

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
        bench = Bench(dev, small, spp, multiprocess=True)
        got, stats = bench.run(mesh, mesh)
        keys = sorted(stats)
        by_rank = pmesh.all_gather_cat(
            mesh, torch.tensor([[float(stats[k]) for k in keys]], dtype=torch.float64,
                               device=dev)).cpu().tolist()
        if rank == 0:
            bench.multiprocess = False
            alone, a_stats = bench.run(None, pmesh.Mesh(devices=(dev,), n_shards=1))
            report("nccl", device, n, n, bench, compare(bench, n, got, alone),
                   [dict(zip(keys, r)) for r in by_rank], a_stats)
    finally:
        dist.destroy_process_group()


def nccl(args, n):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    cmd = [sys.executable, os.path.abspath(__file__), "--mode", "nccl", "--device", args.device,
           "--procs", str(n), "--root", args.root, "--spp", str(args.spp)] + (
               ["--small"] if args.small else [])
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
        raise SystemExit(f"mesh_multi_gpu: {n} workers' exit codes {rcs}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="process", choices=("process", "nccl"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--procs", type=int, default=None)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--spp", type=int, default=4, help="the pool render's samples a pixel")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--worker", nargs=2, metavar=("RANK", "ADDR"))
    args = ap.parse_args()
    args.root = os.path.abspath(args.root)
    sys.path.insert(0, args.root)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("mesh_multi_gpu: torch.cuda.is_available() is False")
    if args.worker:
        return worker(int(args.worker[0]), args.procs, args.worker[1], args.device, args.small,
                      args.spp)
    print(f"mesh_multi_gpu: {args.mode} mode, port from {args.root}, "
          f"{card_line() if args.device == 'cuda' else 'cpu'}", flush=True)
    if args.mode == "process":
        return one_process(args.device, args.small, args.spp)
    count = torch.cuda.device_count() if args.device == "cuda" else 4
    counts = [args.procs] if args.procs else [1 << i for i in range(1, count.bit_length())
                                              if 1 << i <= count]
    if not counts or min(counts) < 2:
        raise SystemExit(f"mesh_multi_gpu: nccl mode needs 2 or more processes, got {counts}")
    for n in counts:
        nccl(args, n)


if __name__ == "__main__":
    main()
