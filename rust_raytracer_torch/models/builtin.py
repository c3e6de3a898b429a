"""Built-in scenes (reference: src/scene/*.rs + scenes/test DSL file).

The port's copy of rust_raytracer_tpu/models/builtin.py, building scenes
from the port's own scene/graph.py; tests/test_torch_scene.py holds the two
packages' compiled scenes leaf-equal.

Each builder returns a SceneDef whose `config` dict carries the scene's
camera defaults (merged defaults <- scene <- CLI by utils/config.py, the
reference's three-layer SceneConfig merge, config.rs:32-43).
"""
from __future__ import annotations

import os

import numpy as np

from ..scene import graph as g
from . import register

# Path to the reference's scene assets (monkey.obj, earthmap.jpg, ...):
# $RRT_ASSET_ROOT, else `assets/` at the root of the checkout (not committed;
# without it cornell_dragon and golden_monkey use their procedural
# stand-ins).
ASSET_ROOT = os.environ.get(
    "RRT_ASSET_ROOT",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir, "assets"),
)


def _asset(path: str) -> str:
    return os.path.join(ASSET_ROOT, path)


@register("test")
def test_scene():
    """The scenes/test DSL scene: glossy floor + glossy ball + bright sky."""
    mat_floor = g.Glossy(g.Constant((0.8, 0.8, 0.8)), g.Constant(0.05), 1.5)
    mat_ball = g.Glossy(g.Constant((0.8, 0.0, 0.2)), g.Constant(1.0), 1.5)
    floor = g.Plane((0, -0.2, 0), (-1, 0, 0), (0, 0, 1), mat_floor)
    ball = g.Sphere((0, 0, 0), 0.2, mat_ball)
    sky = g.Sky(g.Constant((2.0, 2.0, 2.0)))
    world = g.Group([ball, floor, sky])
    return g.SceneDef(world=world, lights=[sky], config={})


@register("golden_monkey")
def golden_monkey(seed: int = 1337):
    """Default scene (reference: scene/golden_monkey.rs): metal Suzanne over
    a checkered floor with 21x21 random glossy/glass spheres under an
    XZ-split BVH, deep blue sky + warm sun.  The random sphere field is
    deterministic here (seeded), unlike the reference's thread_rng.

    Uses resource/monkey.obj if present; without it, a procedural torus
    knot of 2 x 164 x 48 = 15,744 triangles (Suzanne's ~15.7k) scaled to
    about Suzanne's box (2.69 x 1.94 x 1.71) at her place, clear of the
    floor."""
    from ..utils import assets, procgen

    rng = np.random.default_rng(seed)

    mat_ground = g.Lambertian(
        g.Checker(g.Constant((0.2, 0.3, 0.1)), g.Constant((0.9, 0.9, 0.9)), 0.02)
    )
    mat_metal = g.Metal(g.Constant((0.8, 0.6, 0.2)), g.Constant(0.05))
    mat_glass = g.Dielectric(1.5)

    sky = g.Sky(g.Constant((0.2, 0.6, 2.0)))
    sun = g.Sun((-1.0, 1.0, 0.0), g.Constant((20.0, 20.0, 20.0)))

    floor = g.Plane((0, 0, 0), (20, 0, 0), (0, 0, -20), mat_ground)

    monkey_path = _asset("resource/monkey.obj")
    if os.path.exists(monkey_path):
        mesh = assets.load_obj(monkey_path, mat_metal)
        monkey = g.Transform(mesh).translate(0.0, 1.0, 0.0)
    else:
        mesh = procgen.torus_knot_mesh(mat_metal, rings=164, segments=48)
        monkey = g.Transform(mesh).scale(1.05, 0.75, 1.25).translate(0.0, 1.05, 0.0)

    spheres = []
    for i in range(-10, 11):
        for j in range(-10, 11):
            center = np.array(
                [i + rng.uniform(0, 0.9), 0.2, j + rng.uniform(0, 0.9)]
            )
            if np.sum((center - np.array([0.0, 0.2, 0.0])) ** 2) < 1.0:
                continue
            if rng.uniform() < 0.95:
                albedo = rng.uniform(size=3) * rng.uniform(size=3)
                mat = g.Glossy(g.Constant(tuple(albedo)), g.Constant(0.1), 1.5)
                spheres.append(g.Sphere(tuple(center), 0.2, mat))
            else:
                spheres.append(g.Sphere(tuple(center), 0.2, mat_glass))
                spheres.append(g.Sphere(tuple(center), -0.18, mat_glass))

    world = g.Group([monkey, floor, g.Group(spheres, bvh=True), sky, sun])
    return g.SceneDef(
        world=world,
        lights=[sky, sun],
        config=dict(
            output_width=600, aspect_ratio=1.5, focal_length=50.0,
            f_number=2.8, camera_pos=(5.0, 2.0, 9.0),
            camera_target=(0.0, 0.5, 0.0),
        ),
    )


@register("earth")
def earth():
    """reference: scene/earth.rs — textured earth sphere + sun."""
    tex_earth = g.Image.from_file(_asset("resource/earthmap.jpg"))
    mat_earth = g.Glossy(tex_earth, g.Constant(0.7), 1.5)
    mat_floor = g.Glossy(g.Constant((0.5, 0.5, 0.5)), g.Constant(0.01), 1.5)

    earth_s = g.Sphere((0, 0, 0), 1.5, mat_earth)
    floor = g.Plane((0, -1.5, 0), (-10, 0, 0), (0, 0, 10), mat_floor)
    sun = g.Sun((0, 1, 2), g.Constant((10.0, 10.0, 10.0)))

    world = g.Group([floor, earth_s, sun])
    return g.SceneDef(
        world=world, lights=[sun],
        config=dict(
            output_width=600, aspect_ratio=1.5, focal_length=70.0,
            camera_pos=(13.0, 2.0, 3.0), camera_target=(0.0, 0.0, 0.0),
        ),
    )


@register("perlin")
def perlin():
    """reference: scene/perlin_noise.rs — marble Suzanne + sphere."""
    from ..utils import assets

    tex_noise = g.NoiseSolid(g.Perlin(seed=7), scale=2.0)
    marble_alb = g.Lerp(
        g.Constant((0.02, 0.02, 0.03)), g.Constant((0.9, 0.9, 0.9)), tex_noise
    )
    mat_marble = g.Glossy(marble_alb, g.Constant(0.0), 1.5)
    checker_alb = g.Checker(
        g.Constant((0.1, 0.1, 0.1)), g.Constant((0.9, 0.9, 0.9)), 0.02
    )
    mat_floor = g.Glossy(checker_alb, g.Constant(0.01), 1.5)

    floor = g.Plane((0, -1, 0), (-10, 0, 0), (0, 0, 10), mat_floor)
    mesh = assets.load_obj(_asset("resource/monkey.obj"), mat_marble)
    monkey = g.Transform(mesh).scale(1.5).rotate_y(45).translate(0, 0.45, -2)
    sphere = g.Sphere((0, 0, 1.5), 1.0, mat_marble)
    sky = g.Sky(g.Constant((1.0, 1.0, 1.0)))

    world = g.Group([floor, monkey, sphere, sky])
    return g.SceneDef(
        world=world, lights=[sky],
        config=dict(
            output_width=600, aspect_ratio=1.5, focal_length=70.0,
            f_number=4.0, camera_pos=(13.0, 1.0, 4.0),
            camera_target=(0.0, 0.0, 0.0),
        ),
    )


@register("light_test")
def light_test():
    """reference: scene/light_test.rs + scenes/light_test DSL."""
    from ..utils import assets

    mat_metal = g.Metal(g.Constant((0.8, 0.6, 0.2)), g.Constant(0.05))
    mat_light_1 = g.Emissive(g.Constant((7.0, 1.0, 7.0)))
    mat_light_2 = g.Emissive(g.Constant((1.0, 6.0, 8.0)))
    checker_alb = g.Checker(
        g.Constant((0.2, 0.3, 0.1)), g.Constant((0.9, 0.9, 0.9)), 0.02
    )
    checker_rough = g.Checker(g.Constant(0.05), g.Constant(0.9), 0.02)
    mat_floor = g.Glossy(checker_alb, checker_rough, 1.5)

    floor = g.Plane((0, -1, 0), (-10, 0, 0), (0, 0, 10), mat_floor)
    mesh = assets.load_obj(_asset("resource/monkey.obj"), mat_metal)
    monkey = g.Transform(mesh).translate(0, 0, -1.5)
    s1 = g.Sphere((-1, 0, 1), 0.5, mat_light_1)
    s2 = g.Sphere((2, 0.5, -1.2), 0.4, mat_light_2)

    world = g.Group([floor, monkey, s1, s2])
    return g.SceneDef(
        world=world, lights=[s1, s2],
        config=dict(
            output_width=600, aspect_ratio=1.5, focal_length=70.0,
            f_number=4.0, camera_pos=(10.0, 1.0, 6.0),
            camera_target=(0.0, 0.0, 0.0),
        ),
    )


def _cornell_shell():
    mat_white = g.Lambertian(g.Constant((0.73, 0.73, 0.73)))
    mat_green = g.Lambertian(g.Constant((0.12, 0.45, 0.15)))
    mat_red = g.Lambertian(g.Constant((0.65, 0.05, 0.05)))
    walls = [
        g.Plane((277.5, 555, 277.5), (277.5, 0, 0), (0, 0, 277.5), mat_white),
        g.Plane((277.5, 277.5, 555), (0, 277.5, 0), (277.5, 0, 0), mat_white),
        g.Plane((555, 277.5, 277.5), (0, 277.5, 0), (0, 0, -277.5), mat_green),
        g.Plane((0, 277.5, 277.5), (0, 277.5, 0), (0, 0, 277.5), mat_red),
    ]
    return mat_white, walls


_CORNELL_CONFIG = dict(
    output_width=600, aspect_ratio=1.0, focal_length=33.0,
    camera_pos=(277.5, 277.5, -800.0), camera_target=(277.5, 277.5, 0.0),
)


@register("cornell")
def cornell():
    """reference: scene/cornell_box.rs + scenes/cornell DSL."""
    mat_white, walls = _cornell_shell()
    checker = g.Checker(g.Constant(0.0), g.Constant(1.0), 0.25)
    mat_checker = g.Glossy(g.Constant((0.95, 0.95, 0.95)), checker, 1.5)
    mat_light = g.Emissive(g.Constant((15.0, 15.0, 15.0)))
    mat_glass = g.Dielectric(1.5)

    floor = g.Plane(
        (277.5, 0, 277.5), (277.5, 0, 0), (0, 0, -277.5), mat_checker
    )
    light = g.Plane(
        (277.5, 554.9, 277.5), (-65, 0, 0), (0, 0, -52.5), mat_light,
        render_backface=True,
    )
    box = g.Transform(g.Box((0, 0, 0), (165, 330, 165), mat_white))
    box.translate(82.5, 165, 82.5).rotate_y(18).translate(265, 0, 295)
    ball = g.Sphere((212.5, 82.51, 147.5), 82.5, mat_glass)

    world = g.Group([floor] + walls + [light, box, ball])
    return g.SceneDef(
        world=world, lights=[light, ball], config=dict(_CORNELL_CONFIG)
    )


@register("cornell_smoke")
def cornell_smoke():
    """reference: scene/cornell_smoke.rs — small origin-centered Cornell box
    with two constant-density volumes (smoke rho=0.15 black, fog white)."""
    mat_white = g.Lambertian(g.Constant((0.73, 0.73, 0.73)))
    mat_green = g.Lambertian(g.Constant((0.12, 0.45, 0.15)))
    mat_red = g.Lambertian(g.Constant((0.65, 0.05, 0.05)))
    mat_light = g.Emissive(g.Constant((15.0, 15.0, 15.0)))
    mat_smoke = g.Isotropic(g.Constant((0.0, 0.0, 0.0)))
    mat_fog = g.Isotropic(g.Constant((1.0, 1.0, 1.0)))

    floor = g.Plane((0, -27.5, 0), (-27.5, 0, 0), (0, 0, 27.5), mat_white)
    ceiling = g.Plane((0, 27.5, 0), (27.5, 0, 0), (0, 0, -27.5), mat_white)
    back = g.Plane((0, 0, -27.5), (0, 27.5, 0), (-27.5, 0, 0), mat_white)
    left = g.Plane((-27.5, 0, 0), (0, 27.5, 0), (0, 0, -27.5), mat_green)
    right = g.Plane((27.5, 0, 0), (0, 27.5, 0), (0, 0, 27.5), mat_red)
    light = g.Plane((0, 27.49, 0), (13, 0, 0), (0, 0, 10.5), mat_light)

    box1 = g.Transform(g.Box((0, 0, 0), (16.5, 16.5, 16.5), mat_white))
    box1.rotate_y(-15).translate(27.5 - 21.25, 8.25 - 27.5, 27.5 - 14.75)
    box2 = g.Transform(g.Box((0, 0, 0), (16.5, 33.0, 16.5), mat_white))
    box2.rotate_y(18).translate(27.5 - 34.75, 16.5 - 27.5, 27.5 - 37.75)

    vol1 = g.Volume(box1, mat_smoke, 0.15)
    vol2 = g.Volume(box2, mat_fog, 0.15)

    world = g.Group([floor, ceiling, back, left, right, light, vol1, vol2])
    return g.SceneDef(
        world=world, lights=[light],
        config=dict(
            output_width=600, aspect_ratio=1.0, focal_length=35.0,
            camera_pos=(0.0, 0.0, 110.0), camera_target=(0.0, 0.0, 0.0),
        ),
    )


@register("cornell_dragon")
def cornell_dragon():
    """scenes/cornell_dragon: Cornell box + 870k-tri glossy mesh.

    Uses the real Stanford dragon OBJ if present; the mounted reference
    strips it (.MISSING_LARGE_BLOBS), so the default is a procedurally
    generated torus-knot tube with a matched ~870k triangle count.
    """
    from ..utils import assets, procgen

    mat_white, walls = _cornell_shell()
    mat_light = g.Emissive(g.Constant((15.0, 15.0, 15.0)))
    mat_gloss = g.Glossy(g.Constant((0.73, 0.73, 0.73)), g.Constant(0.0), 1.5)

    floor = g.Plane(
        (277.5, 0, 277.5), (277.5, 0, 0), (0, 0, -277.5), mat_white
    )
    light = g.Plane(
        (277.5, 554.9, 277.5), (-130, 0, 0), (0, 0, -105), mat_light,
        render_backface=True,
    )

    dragon_path = _asset("resource/dragon_high.obj")
    if os.path.exists(dragon_path):
        mesh = assets.load_obj(dragon_path, mat_gloss)
        dragon = g.Transform(mesh).scale(60).rotate_y(225).translate(267.5, 0.5, 277.5)
    else:
        mesh = procgen.torus_knot_mesh(mat_gloss)
        dragon = g.Transform(mesh).scale(110).rotate_y(225).translate(
            267.5, 200.0, 277.5
        )

    world = g.Group([floor] + walls + [light, dragon])
    return g.SceneDef(world=world, lights=[light], config=dict(_CORNELL_CONFIG))


@register("tonemap_test")
def tonemap_test():
    """reference: scene/tonemap_test.rs + scenes/tonemap_test DSL —
    12-sphere exposure chart under a very bright sky."""
    spheres = []
    for col, channel in enumerate(["r", "g", "b"]):
        x = -2.5 + 2.5 * col
        for row, val in enumerate([0.1, 0.2, 0.5, 1.0]):
            z = -5.0 + 2.5 * row
            rgb = [0.0, 0.0, 0.0]
            rgb[col] = val
            mat = g.Glossy(g.Constant(tuple(rgb)), g.Constant(0.0), 1.5)
            spheres.append(g.Sphere((x, 0.5, z), 0.5, mat))
    floor = g.Plane(
        (0, 0, 0), (-10, 0, 0), (0, 0, 10),
        g.Glossy(g.Constant((0.5, 0.5, 0.5)), g.Constant(0.5), 1.5),
    )
    sky = g.Sky(g.Constant((25.0, 25.0, 25.0)))
    world = g.Group(spheres + [floor, sky])
    return g.SceneDef(
        world=world, lights=[sky],
        config=dict(
            output_width=600, aspect_ratio=1.0, focal_length=35.0,
            camera_pos=(0.0, 30.0, 15.0), camera_target=(0.0, 0.0, -0.75),
        ),
    )
