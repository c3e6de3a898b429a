"""Render rates of one checkout of the port, for comparing two checkouts on
one card.

    python3 scripts/render_rates.py                     # this checkout
    python3 scripts/render_rates.py --root OTHER_TREE   # another checkout's package

Imports `rust_raytracer_torch` from `--root` (a checkout of this repo,
default the one holding this script), builds its kernels, and renders
cornell_dragon at 1200x1200, 1 spp, depth 20 with 2^18 lanes, as
chip_smoke.py's main paths do: the pool with kernel="auto" (K1) and with
kernel="wavefront", and the batch render with kernel="threaded" (K3), each
once to capture its graphs and then `--reps` times, timed on the host
clock between two `torch.cuda.synchronize()` calls; then the CLI
(`utils/cli.py:main`) on the same scene once, reading the
pixel-samples/s of its metrics line.  Prints the card's name and power
limit, then one JSON line of the rates (each run's, unrounded).  Run two
checkouts in turns in one call (A, B, B, A) to compare them: the host's
share of a batch render spreads between runs.

Needs CUDA; exits non-zero without it.
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

sys.modules["jax"] = None  # the port runs without JAX

W, SPP, DEPTH, LANES = 1200, 1, 20, 1 << 18


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("render_rates: torch.cuda.is_available() is False")
    from rust_raytracer_torch import models
    from rust_raytracer_torch.ops import _cuda
    from rust_raytracer_torch.render.camera import camera_from_config
    from rust_raytracer_torch.render.renderer import Renderer
    from rust_raytracer_torch.utils import cli
    from rust_raytracer_torch.utils import config as cfg

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; package from {root}", flush=True)
    _cuda.build_library()
    dev = torch.device("cuda:0")
    scene = models.build("cornell_dragon")
    sc = cfg.merge_scene_config(scene.config, {"output_width": W})
    camera = camera_from_config(sc, cfg.RenderConfig(samples_per_pixel=SPP, max_depth=DEPTH))
    total = camera.image_width * camera.image_height * SPP
    rates = {}
    for tag, kernel, mode in (("pool auto", "auto", "pool"), ("pool wavefront", "wavefront", "pool"),
                              ("batch threaded", "threaded", "batch")):
        r = Renderer(scene, camera, batch_size=LANES, kernel=kernel, device=dev)
        r.render(mode=mode)
        runs = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render(mode=mode)
            torch.cuda.synchronize()
            runs.append(total / (time.perf_counter() - t0))
        rates[tag] = runs
        del r
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["cornell_dragon", f"-w={W}", f"-s={SPP}", f"--max-depth={DEPTH}",
                  f"-o={os.path.join(root, 'build', 'render_rates_cli.png')}", "--metrics=1"])
    line = [ln for ln in out.getvalue().splitlines() if ln.startswith('{"render_metrics"')]
    rates["cli"] = [json.loads(line[-1])["render_metrics"]["pixel_samples_per_s"]]
    print(json.dumps({"root": root, "pixel_samples_per_s": rates}), flush=True)


if __name__ == "__main__":
    main()
