"""The `golden_monkey` scene as the reference builds it: the reference's
src/scene/golden_monkey.rs (a metal Suzanne over a checkered ground, a
21x21 field of small spheres, glossy or hollow glass, a blue sky and a
warm sun, both lights), a frozen copy of the program's built-in
`golden_monkey` in the reference's own scene description.

Departures from the reference, the program's own: the sphere field is
drawn from numpy's default_rng(1337), where the reference draws from an
unseeded thread_rng (golden_monkey.rs:83-118), so both sides place the
same spheres; and Suzanne (resource/monkey.obj, ~15.7k triangles, not in
the repository) is the procedural torus knot of 2 x 164 x 48 = 15,744
triangles that the program's built-in uses when the OBJ is absent, scaled
to about Suzanne's box at her place.  `knot_rings` and `knot_segments` in
the configuration size the knot (tests use a small one)."""
import numpy as np

from perfbench.reference import graph as g
from perfbench.reference import procgen

SOURCE_SCENE = "golden_monkey"
SEED = 1337


def build(config: dict) -> g.SceneDef:
    rng = np.random.default_rng(SEED)
    mat_ground = g.Lambertian(
        g.Checker(g.Constant((0.2, 0.3, 0.1)), g.Constant((0.9, 0.9, 0.9)), 0.02))
    mat_metal = g.Metal(g.Constant((0.8, 0.6, 0.2)), g.Constant(0.05))
    mat_glass = g.Dielectric(1.5)

    sky = g.Sky(g.Constant((0.2, 0.6, 2.0)))
    sun = g.Sun((-1.0, 1.0, 0.0), g.Constant((20.0, 20.0, 20.0)))
    floor = g.Plane((0, 0, 0), (20, 0, 0), (0, 0, -20), mat_ground)

    mesh = procgen.torus_knot_mesh(mat_metal, rings=int(config.get("knot_rings", 164)),
                                   segments=int(config.get("knot_segments", 48)))
    monkey = g.Transform(mesh).scale(1.05, 0.75, 1.25).translate(0.0, 1.05, 0.0)

    spheres = []
    for i in range(-10, 11):
        for j in range(-10, 11):
            center = np.array([i + rng.uniform(0, 0.9), 0.2, j + rng.uniform(0, 0.9)])
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
    return g.SceneDef(world=world, lights=[sky, sun], config={})
