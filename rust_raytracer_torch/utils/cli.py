"""CLI entry (reference: src/main.rs; port of rust_raytracer_tpu/utils/cli.py).

    python -m rust_raytracer_torch [scene|file.dsl|model:path] -w=600 -s=250 ...

Dispatch order matches main.rs:30-59: builtin scene name (default
golden_monkey), `model:` asset path, else DSL scene file.  Renders on the
CUDA card through the pool renderer, ACES tonemaps and writes a PNG
(default out.png).  `--metrics=1` prints one JSON line of render metrics;
`--profile=DIR` writes a torch.profiler trace under DIR.
"""
from __future__ import annotations

import sys

from . import config as cfg
from . import log


def main(argv=None, device="cuda"):
    """Run the CLI on `argv` (default sys.argv[1:]).  The render runs on
    `device`: the card unless a caller asks for the CPU; without CUDA the
    Renderer raises, nothing falls back to the CPU."""
    argv = list(sys.argv[1:] if argv is None else argv)
    scene_name, cli_scene, render_cfg = cfg.parse_args(argv)

    from .. import models
    from ..render.camera import camera_from_config
    from ..render.renderer import Renderer
    from ..scene import dsl

    with log.Timer("Ready"):
        if scene_name == "" or scene_name in models.names():
            scene = models.build(scene_name or "golden_monkey")
        elif scene_name.startswith("model:"):
            from . import model_import

            scene = model_import.load_model(scene_name[len("model:"):])
        else:
            scene = dsl.load_scene_file(scene_name, perlin_seed=render_cfg.seed)

        scene_config = cfg.merge_scene_config(scene.config, cli_scene)
        # the compiler reads the background from scene.config
        scene.config["background"] = scene_config["background"]
        camera = camera_from_config(scene_config, render_cfg)
        renderer = Renderer(scene, camera, seed=render_cfg.seed, device=device)

    w, h = camera.image_width, camera.image_height
    spp = camera.actual_spp
    spt = spp // camera.thread_count
    log.info(
        f"Rendering: {w}x{h} @{spp}spp on {camera.thread_count} threads "
        f"({spt} samples/thread)"
    )

    from . import metrics as metricsmod

    render_metrics = None
    if render_cfg.metrics:
        render_metrics = metricsmod.RenderMetrics(
            n_pixels=w * h, spp=spp, max_depth=camera.max_depth
        )

    with metricsmod.profiler_trace(render_cfg.profile_dir or None):
        with log.Timer("Done"):
            film = renderer.render(metrics=render_metrics)

    if render_metrics is not None:
        render_metrics.emit()
    film.save(render_cfg.output, tonemap="aces")
    log.info(f"Wrote {render_cfg.output}. Goodbye :)")
    return 0
