"""The graphed renders over several GPUs of one process: the batch render's
batch program, and the pool step's graph.

    python3 scripts/mesh_batch_program.py                   # 2 shards, then one a GPU
    python3 scripts/mesh_batch_program.py --device cpu --small   # rehearsal on the CPU

Builds cornell_dragon and renders it at 1200x1200, 1 spp, depth 20 with
render(mode="batch") through K3 in batches of 2^18 lanes: first unsharded
on the first device (graphed, the reference image), then on
parallel/mesh.py's make_mesh(k) for k = 2 and k = the device count (one
process, one shard a GPU), eager and graphed in turns (eager, graphed,
graphed, eager).  Graphed, a batch is one launch of each shard's batch
program (render/renderer.py:BatchProgram), built, instantiated and
launched on its shard's device.  It checks that every image equals the
unsharded one bit for bit (render_batched sums each pixel in the same
order whatever the shard count), that the K3 launches equal the bounces,
that the graphed renders launch loop_cond once a bounce and each
program's loop once a batch, and that each program's loop graph lives on
its shard's device.  On each mesh it also renders the pool
(render(mode="pool"), one GraphedStep capture a shard on its device)
graphed and eager: the images agree within float sum order (mean |d| /
mean <= 1e-5, as chip_smoke.py's phase 25 holds the graphed pool) and the
K3 launches equal shards x steps both ways.  It prints the card line, each render's rate and a
JSON line of it all; any failed check raises, so the exit code is
non-zero.  --small renders the "test" scene at 32x32 with batches of 256
lanes on two CPU shards, where the batch programs run their plain loop
(render/graphs.py:PlainLoop) and the pool step's capture is its body
called at each replay: the graphed paths are taken there as on the card.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.modules["jax"] = None  # the port runs without JAX

import numpy as np  # noqa: E402
import torch  # noqa: E402


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


def render(r, graph):
    """(image, seconds, BatchMetrics, launches by kernel, loop launches by
    device) of one batch render of `r`."""
    from rust_raytracer_torch.render import graphs
    from rust_raytracer_torch.render.renderer import BatchMetrics

    r.graph = graph
    m = BatchMetrics()
    loops = {}
    real = graphs.LoopGraph.launch

    def launch(self):
        loops[str(self.device)] = loops.get(str(self.device), 0) + 1
        return real(self)

    before = graphs.launch_counts()
    graphs.LoopGraph.launch = launch
    try:
        sync()
        t0 = time.perf_counter()
        img = r.render(mode="batch", metrics=m).hdr()
        sync()
        secs = time.perf_counter() - t0
    finally:
        graphs.LoopGraph.launch = real
    launched = {k: v - before[k] for k, v in graphs.launch_counts().items() if v != before[k]}
    return img, secs, m, launched, loops


def check(tag, r, graph, got, want):
    img, secs, m, launched, loops = got
    n_diff = int((img != want).any(axis=-1).sum())
    shards = 1 if r.mesh is None else r.mesh.n_shards
    on_card = r.device.type == "cuda"
    wanted = {"threaded_traverse": m.bounces} if on_card else {}   # the CPU counts no launch
    if graph and on_card:
        wanted["loop_cond"] = m.bounces
    if on_card and graph:
        devs = [str(d) for d in (r.mesh.devices if r.mesh else [r.device])]
        want_loops = {d: m.batches for d in devs}
        progs = r._batch_run(r.batch_size, m_total(r), r.camera.actual_spp).programs
        homes = [(str(p.loop.device), str(p.out.device)) for p in progs]
    else:
        want_loops, homes = {}, []
    print(f"{tag}: {'graphed' if graph else 'eager'} {secs:.3f} s, {m.batches} batches, "
          f"{m.bounces} bounces on {shards} shard(s), launches {launched}, loop graph launches "
          f"{loops}; {n_diff} pixels not bit-equal to the unsharded image", flush=True)
    if n_diff or launched != wanted or loops != want_loops or any(a != b for a, b in homes):
        raise AssertionError(f"{tag}: image differs ({n_diff} pixels), launches {launched} "
                             f"against {wanted}, loops {loops} against {want_loops}, loop "
                             f"and program devices {homes}")
    return secs


def pool_pair(tag, r):
    """The pool render of `r` graphed and eager (K3): (graphed seconds,
    eager seconds)."""
    from rust_raytracer_torch.render import graphs
    from rust_raytracer_torch.utils.metrics import RenderMetrics

    imgs, secs = {}, {}
    shards = 1 if r.mesh is None else r.mesh.n_shards
    for graph in (True, False):
        r.graph = graph
        m = RenderMetrics()
        before = graphs.launch_counts()
        sync()
        t0 = time.perf_counter()
        imgs[graph] = r.render(mode="pool", metrics=m).hdr()
        sync()
        secs[graph] = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in graphs.launch_counts().items()
                    if v != before[k]}
        wanted = {"threaded_traverse": m.steps * shards} if r.device.type == "cuda" else {}
        if launched != wanted:
            raise AssertionError(f"{tag} pool: launches {launched} against {wanted}")
    rel = float(np.abs(imgs[True] - imgs[False]).mean() / np.abs(imgs[False]).mean())
    print(f"{tag}: pool graphed {secs[True]:.3f} s (its capture included), eager "
          f"{secs[False]:.3f} s, {m.steps} steps on {shards} shard(s), K3 launches = shards x "
          f"steps; graphed vs eager mean |d|/mean {rel:.3e}", flush=True)
    if not (np.isfinite(imgs[True]).all() and rel <= 1e-5):
        raise AssertionError(f"{tag}: the graphed pool image differs from the eager one")
    return secs[True], secs[False]


def m_total(r):
    return r.camera.image_width * r.camera.image_height * r.camera.actual_spp


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)

    from rust_raytracer_torch import models
    from rust_raytracer_torch.ops import intersect as isect
    from rust_raytracer_torch.parallel import mesh as pmesh
    from rust_raytracer_torch.render import graphs
    from rust_raytracer_torch.render.camera import camera_from_config
    from rust_raytracer_torch.render.renderer import Renderer
    from rust_raytracer_torch.utils import config as cfg

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        n_dev = torch.cuda.device_count()
        if n_dev < 2:
            raise SystemExit(f"{n_dev} CUDA device(s); the sharded render needs 2 or more")
        print(card_line(), flush=True)
        counts = sorted({2, n_dev})
        dev = "cuda:0"
    else:
        # the graphed paths on the CPU: the batch program's loop plain, the
        # pool step's "capture" its body called at each replay
        graphs.applies = lambda device, kernel, pack: isect.resolve_kernel(kernel, pack) != "jnp"
        graphs.cuda_capture = lambda body, device: types.SimpleNamespace(replay=body)
        counts, dev = [2], "cpu"
    name, width, batch = ("test", 32, 256) if args.small else ("cornell_dragon", 1200, 1 << 18)
    scene = models.build(name)
    cam = camera_from_config(cfg.merge_scene_config(scene.config, {"output_width": width}),
                             cfg.RenderConfig(samples_per_pixel=1, max_depth=20))
    t0 = time.perf_counter()
    r = Renderer(scene, cam, batch_size=batch, kernel="threaded", device=dev)
    print(f"{name}: compiled in {time.perf_counter() - t0:.1f} s", flush=True)
    total = m_total(r)
    render(r, True)   # builds the kernels and the unsharded program
    ref = render(r, True)
    want = ref[0]
    check("unsharded", r, True, ref, want)
    out = {"scene": name, "width": width, "spp": 1, "depth": 20, "batch": batch,
           "unsharded_graphed_s": ref[1], "bounces": ref[2].bounces, "meshes": {}}
    for k in counts:
        r.mesh = pmesh.make_mesh(k, device=args.device)
        tag = f"make_mesh({k})"
        secs = {False: [], True: []}
        for graph in (False, True, True, False):
            secs[graph].append(check(tag, r, graph, render(r, graph), want))
        e_s, g_s = float(np.mean(secs[False])), secs[True][1]
        print(f"{tag}: eager {total / e_s:.1f} pixel-samples/s ({e_s:.3f} s, mean of 2), graphed "
              f"{total / g_s:.1f} ({g_s:.3f} s; the first graphed render {secs[True][0]:.3f} s "
              f"with its build); unsharded graphed {total / ref[1]:.1f} ({ref[1]:.3f} s)",
              flush=True)
        pool_g, pool_e = pool_pair(tag, r)
        out["meshes"][k] = {"eager_s": e_s, "graphed_s": g_s, "first_graphed_s": secs[True][0],
                            "pool_graphed_s": pool_g, "pool_eager_s": pool_e}
    r.mesh = None
    print(json.dumps({"mesh_batch_program": out}), flush=True)


if __name__ == "__main__":
    main()
