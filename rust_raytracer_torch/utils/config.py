"""Scene and render configuration (reference: src/config.rs).

The port's copy of rust_raytracer_tpu/utils/config.py: the scene-config
defaults, the option merge (DEFAULTS <- scene config <- overrides) and the
render parameters.  The CLI's flag parser is not ported yet (ROADMAP); the
camera is built by render/camera.py:camera_from_config.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

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


def merge_scene_config(*layers: Dict[str, object]) -> Dict[str, object]:
    """Option-merge: later layers override where set (config.rs:32-43)."""
    out = dict(DEFAULT_SCENE_CONFIG)
    for layer in layers:
        for k, v in layer.items():
            if v is not None:
                out[k] = v
    return out
