"""Scene and render configuration (reference: src/config.rs).

The port's copy of rust_raytracer_tpu/utils/config.py: the scene-config
defaults, the option merge (DEFAULTS <- scene config <- CLI flags), the
render parameters and the CLI's flag parser, with the reference's flag
grammar (`-k=v`, config.rs:62-152).  The camera is built by
render/camera.py:camera_from_config (the reference's make_camera).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

# reference DEFAULT_SCENE_CONFIG (config.rs:20-29)
DEFAULT_SCENE_CONFIG: Dict[str, object] = dict(
    output_width=600,
    aspect_ratio=1.5,
    focal_length=50.0,
    f_number=None,
    focus_distance=None,
    camera_pos=(0.0, 0.0, 1.0),
    camera_target=(0.0, 0.0, 0.0),
    background=(0.0, 0.0, 0.0),
)


@dataclasses.dataclass
class RenderConfig:
    """CameraConfig equivalent (config.rs:46-52) + framework extras."""
    thread_count: int = 1
    samples_per_pixel: int = 250
    max_depth: int = 20
    light_bias: float = 0.25
    seed: int = 0
    output: str = "out.png"
    metrics: bool = False        # emit a render-metrics JSON line at exit
    profile_dir: str = ""        # torch.profiler trace directory ("" = off)


def merge_scene_config(*layers: Dict[str, object]) -> Dict[str, object]:
    """Option-merge: later layers override where set (config.rs:32-43)."""
    out = dict(DEFAULT_SCENE_CONFIG)
    for layer in layers:
        for k, v in layer.items():
            if v is not None:
                out[k] = v
    return out


_ARG_RE = re.compile(r"^-([^=\s]+)=([^=\s]+)$")


def _parse_vec(s: str) -> Tuple[float, float, float]:
    parts = [float(x) for x in s.split(",")]
    assert len(parts) == 3, "Vector must have three components"
    return tuple(parts)


def parse_args(argv: List[str]):
    """Parse CLI args into (scene_name, cli_scene_config, render_config).

    Mirrors config.rs:62-152: `-k=v` flags anywhere, one bare arg = scene
    name / DSL path / `model:` path.
    """
    scene_overrides: Dict[str, object] = {}
    render = RenderConfig()
    scene_name = ""

    for arg in argv:
        if arg.startswith("-"):
            m = _ARG_RE.match(arg)
            if not m:
                continue  # parity: unmatched flags are ignored
            key, value = m.group(1), m.group(2)
            if key in ("w", "-width"):
                scene_overrides["output_width"] = int(value)
            elif key in ("r", "-aspect-ratio"):
                scene_overrides["aspect_ratio"] = float(value)
            elif key in ("f", "-focal-length"):
                scene_overrides["focal_length"] = float(value)
            elif key in ("a", "-aperture"):
                scene_overrides["f_number"] = float(value)
            elif key in ("d", "-focus-dist"):
                scene_overrides["focus_distance"] = float(value)
            elif key in ("c", "-camera-position"):
                scene_overrides["camera_pos"] = _parse_vec(value)
            elif key in ("l", "-look-at"):
                scene_overrides["camera_target"] = _parse_vec(value)
            elif key in ("b", "-background-color"):
                scene_overrides["background"] = _parse_vec(value)
            elif key in ("t", "-threads"):
                render.thread_count = int(value)
            elif key in ("s", "-samples"):
                render.samples_per_pixel = int(value)
            elif key == "-max-depth":
                render.max_depth = int(value)
            elif key == "-light-bias":
                render.light_bias = float(value)
                assert 0.0 <= render.light_bias <= 1.0, \
                    "Light bias must be in range [0; 1]"
            elif key == "-seed":
                render.seed = int(value)
            elif key in ("o", "-output"):
                render.output = value
            elif key == "-metrics":
                render.metrics = value.lower() not in ("0", "false", "no")
            elif key == "-profile":
                render.profile_dir = value
            # unknown keys ignored (parity with `_ => ()`)
        else:
            scene_name = arg

    return scene_name, scene_overrides, render


def make_camera(scene_config: Dict[str, object], render: RenderConfig):
    """Build a render.Camera from merged configs (the reference's name for
    render/camera.camera_from_config)."""
    from ..render.camera import camera_from_config

    return camera_from_config(scene_config, render)
