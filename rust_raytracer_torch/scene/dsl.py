"""Scene DSL loader (reference: src/loaders/scene.rs, docs/scene_dsl.md).

Same grammar: one declaration per line (`label: type params...`), `@config`
directives, `$label` references, paren-nested inline declarations, entity
namespaces (objects / materials / color textures / float textures / noise).
Parse errors warn with line numbers and skip the line (scene.rs:93-96,
127-134); a scene missing `world` or `lights` is rejected (scene.rs:138-155).

Output is a host-side SceneDef (scene/graph.py) ready for compile_scene.

The port's copy of rust_raytracer_tpu/scene/dsl.py, held equal to it by
tests/test_torch_cli.py (both packages compile what it loads to equal
tables).
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np

from ..utils import log
from . import graph as g


class DslError(ValueError):
    pass


def _parse_vec(s: str):
    parts = s.split(",")
    if len(parts) != 3:
        raise DslError("Vector must have three components")
    return [float(x) for x in parts]


def _split_params(decl: str) -> List[str]:
    """Paren-aware space tokenizer (scene.rs:214-245)."""
    params, current, nest = [], [], 0
    for ch in decl:
        if ch == "(":
            current.append(ch)
            nest += 1
        elif ch == ")":
            current.append(ch)
            nest -= 1
        elif ch == " " and nest == 0:
            params.append("".join(current))
            current = []
        else:
            current.append(ch)
    params.append("".join(current))
    return [p for p in params if p != ""]


_TRANSFORM_RE = re.compile(r"^([^=\s]+)=([^=\s]+)$")


class SceneLoader:
    """Interprets the DSL into graph objects (scene.rs:80-156)."""

    def __init__(self, asset_path: str = "", perlin_seed: int = 0):
        self.asset_path = asset_path
        self.objects: Dict[str, g.Object] = {}
        self.materials: Dict[str, g.Material] = {}
        self.color_tex: Dict[str, g.Texture] = {}
        self.float_tex: Dict[str, g.Texture] = {}
        self.noise: Dict[str, g.Perlin] = {}
        self.config: Dict[str, object] = {}
        self._perlin_seed = perlin_seed

    # ---------------- entry ----------------

    def load(self, text: str) -> g.SceneDef:
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            try:
                if line.startswith("@"):
                    self._directive(line[1:])
                    continue
                if ":" not in line:
                    raise DslError("expected 'label: declaration'")
                label, decl = line.split(":", 1)
                entity = self._parse_declaration(decl.strip())
                self._bind(label.strip(), entity)
            except Exception as e:  # warn + skip, like the reference
                log.warning(f"[line {lineno}] {e}")

        world = self.objects.get("world")
        lights = self.objects.get("lights")
        if world is None:
            raise DslError("scene must assign the 'world' label")
        if lights is None:
            raise DslError("scene must assign the 'lights' label")
        light_items = lights.items if isinstance(lights, g.Group) else [lights]
        return g.SceneDef(world=world, lights=light_items, config=dict(self.config))

    # ---------------- directives (scene.rs:158-212) ----------------

    def _directive(self, content: str):
        if not content.startswith("config"):
            raise DslError(f"unknown directive @{content.split()[0]}")
        body = content[len("config"):].strip()
        if "=" not in body:
            raise DslError(f"@config {body}")
        key, value = (x.strip() for x in body.split("=", 1))
        if key == "output_width":
            self.config[key] = int(value)
        elif key == "aspect_ratio":
            if "/" in value:
                a, b = (float(x.strip()) for x in value.split("/", 1))
                self.config[key] = a / b
            else:
                self.config[key] = float(value)
        elif key in ("focal_length", "f_number", "focus_distance"):
            self.config[key] = float(value)
        elif key in ("camera_pos", "camera_target"):
            self.config[key] = tuple(_parse_vec(value))
        # unknown keys silently ignored (parity with the `_ => ()` arm)

    # ---------------- binding & lookup ----------------

    def _bind(self, label: str, entity):
        kind, value = entity
        if label in ("world", "lights") and kind != "object":
            raise DslError(f"'{label}' must be an object")
        {"object": self.objects, "material": self.materials,
         "color": self.color_tex, "float": self.float_tex,
         "noise": self.noise}[kind][label] = value

    def _resolve(self, expr: str):
        """$label lookup or inline (…) declaration -> (kind, value)."""
        expr = expr.strip()
        if expr.startswith("$"):
            label = expr[1:]
            for kind, table in (
                ("object", self.objects), ("material", self.materials),
                ("color", self.color_tex), ("float", self.float_tex),
                ("noise", self.noise),
            ):
                if label in table:
                    return kind, table[label]
            raise DslError(f"undefined reference ${label}")
        if expr.startswith("(") and expr.endswith(")"):
            return self._parse_declaration(expr[1:-1])
        raise DslError(f"expected $ref or (inline declaration), got '{expr}'")

    def _get(self, expr: str, kind: str):
        k, v = self._resolve(expr)
        if k != kind:
            raise DslError(f"expected {kind}, got {k} from '{expr}'")
        return v

    def _get_object(self, e):
        return self._get(e, "object")

    def _get_material(self, e):
        return self._get(e, "material")

    def _get_color_tex(self, e):
        return self._get(e, "color")

    def _get_float_tex(self, e):
        return self._get(e, "float")

    def _get_texture(self, e):
        k, v = self._resolve(e)
        if k not in ("color", "float"):
            raise DslError(f"expected texture, got {k}")
        return k, v

    # ---------------- declarations (scene.rs:247-290) ----------------

    def _parse_declaration(self, decl: str):
        params = _split_params(decl)
        if not params:
            raise DslError("empty declaration")
        kind, args = params[0], params[1:]
        fn = getattr(self, f"_c_{kind}", None)
        if fn is None:
            raise DslError(f"Unknown object type '{kind}'")
        return fn(args)

    # textures
    def _c_constant(self, a):
        try:
            vec = _parse_vec(a[0])
            return "color", g.Constant(tuple(vec))
        except (DslError, ValueError):
            return "float", g.Constant(float(a[0]))

    def _checker(self, a, solid):
        k1, t1 = self._get_texture(a[0])
        t2 = self._get(a[1], k1)
        scale = float(a[2]) if len(a) > 2 else 1.0
        cls = g.CheckerSolid if solid else g.Checker
        return k1, cls(t1, t2, scale)

    def _c_checker(self, a):
        return self._checker(a, False)

    def _c_checker_solid(self, a):
        return self._checker(a, True)

    def _c_lerp(self, a):
        k1, t1 = self._get_texture(a[0])
        t2 = self._get(a[1], k1)
        t = self._get_float_tex(a[2])
        return k1, g.Lerp(t1, t2, t)

    def _c_noise(self, a):
        raise DslError("Not implemented")  # parity: scene.rs:255

    def _c_noise_solid(self, a):
        noise = self._get(a[0], "noise")
        scale = float(a[1]) if len(a) > 1 else 1.0
        samples = int(a[2]) if len(a) > 2 else 7
        return "float", g.NoiseSolid(noise, scale=scale, samples=samples)

    def _c_image(self, a):
        path = os.path.join(self.asset_path, a[0]) if self.asset_path else a[0]
        return "color", g.Image.from_file(path)

    def _c_channel(self, a):
        tex = self._get_color_tex(a[0])
        return "float", g.Channel(tex, int(a[1]))

    def _c_uv_debug(self, a):
        return "color", g.UvDebug()

    # materials
    def _c_lambertian(self, a):
        return "material", g.Lambertian(self._get_color_tex(a[0]))

    def _c_metal(self, a):
        return "material", g.Metal(
            self._get_color_tex(a[0]), self._get_float_tex(a[1])
        )

    def _c_glass(self, a):
        ior = float(a[0]) if a else 1.5
        return "material", g.Dielectric(ior)

    def _c_glossy(self, a):
        albedo = self._get_color_tex(a[0])
        rough = self._get_float_tex(a[1])
        ior = float(a[2]) if len(a) > 2 else 1.5
        nm = self._get_color_tex(a[3]) if len(a) > 3 else None
        return "material", g.Glossy(albedo, rough, ior, nm)

    def _c_emissive(self, a):
        return "material", g.Emissive(self._get_color_tex(a[0]))

    def _c_isotropic(self, a):
        return "material", g.Isotropic(self._get_color_tex(a[0]))

    def _c_normal_debug(self, a):
        nm = self._get_color_tex(a[0]) if a else None
        return "material", g.NormalDebug(nm)

    # objects
    def _c_sphere(self, a):
        return "object", g.Sphere(
            _parse_vec(a[0]), float(a[1]), self._get_material(a[2])
        )

    def _c_plane(self, a):
        plane = g.Plane(
            _parse_vec(a[0]), _parse_vec(a[1]), _parse_vec(a[2]),
            self._get_material(a[3]),
            render_backface=(len(a) > 4 and a[4] == "backface"),
        )
        return "object", plane

    def _c_box(self, a):
        return "object", g.Box(
            _parse_vec(a[0]), _parse_vec(a[1]), self._get_material(a[2])
        )

    def _c_mesh(self, a):
        from ..utils import assets

        path = os.path.join(self.asset_path, a[0]) if self.asset_path else a[0]
        return "object", assets.load_obj(path, self._get_material(a[1]))

    def _c_transform(self, a):
        obj = self._get_object(a[0])
        tr = g.Transform(obj)
        for param in a[1:]:
            m = _TRANSFORM_RE.match(param)
            if not m:
                continue
            key, value = m.group(1), m.group(2)
            if key == "t":
                tr.translate(*_parse_vec(value))
            elif key == "s":
                try:
                    tr.scale(*_parse_vec(value))
                except (DslError, ValueError):
                    tr.scale(float(value))
            elif key == "rx":
                tr.rotate_x(float(value))
            elif key == "ry":
                tr.rotate_y(float(value))
            elif key == "rz":
                tr.rotate_z(float(value))
        return "object", tr

    def _c_list(self, a):
        return "object", g.Group([self._get_object(x) for x in a])

    def _c_bvh(self, a):
        # first param is the split-axes mask in the reference (scene.rs:820);
        # our compiler builds acceleration automatically, so it only selects
        # the member list
        return "object", g.Group(
            [self._get_object(x) for x in a[1:]], bvh=True
        )

    def _c_sky(self, a):
        return "object", g.Sky(self._get_color_tex(a[0]))

    def _c_sun(self, a):
        return "object", g.Sun(_parse_vec(a[0]), self._get_color_tex(a[1]))

    def _c_volume(self, a):
        boundary = self._get_object(a[0])
        material = self._get_material(a[1])
        return "object", g.Volume(boundary, material, float(a[2]))

    def _c_perlin(self, a):
        seed = self._perlin_seed
        self._perlin_seed += 1
        return "noise", g.Perlin(seed=seed)


def load_scene_file(path: str, perlin_seed: int = 0) -> g.SceneDef:
    """Load a DSL scene file; asset paths resolve relative to its directory
    (main.rs:46-56)."""
    asset_path = os.path.dirname(path)
    with open(path) as f:
        text = f.read()
    return SceneLoader(asset_path, perlin_seed).load(text)
