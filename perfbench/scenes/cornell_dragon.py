"""The `cornell_dragon` scene as the reference builds it: the reference's
scenes/cornell_dragon (the Cornell shell, a large area light, a glossy
mesh), with the procedural torus-knot stand-in for the dragon OBJ that the
program's built-in scene uses when the OBJ is absent (869,556 triangles),
a frozen copy of the program's built-in `cornell_dragon` in the
reference's own scene description.  `knot_rings` and `knot_segments` in the
configuration size the knot (tests use a small one)."""
from perfbench.reference import graph as g
from perfbench.reference import procgen
from perfbench.scenes import cornell

SOURCE_SCENE = "cornell_dragon"
CAMERA = cornell.CAMERA


def build(config: dict) -> g.SceneDef:
    mat_white, walls = cornell.shell()
    mat_light = g.Emissive(g.Constant((15.0, 15.0, 15.0)))
    mat_gloss = g.Glossy(g.Constant((0.73, 0.73, 0.73)), g.Constant(0.0), 1.5)
    floor = g.Plane((277.5, 0, 277.5), (277.5, 0, 0), (0, 0, -277.5), mat_white)
    light = g.Plane((277.5, 554.9, 277.5), (-130, 0, 0), (0, 0, -105), mat_light,
                    render_backface=True)
    mesh = procgen.torus_knot_mesh(mat_gloss, rings=int(config.get("knot_rings", 933)),
                                   segments=int(config.get("knot_segments", 466)))
    dragon = g.Transform(mesh).scale(110).rotate_y(225).translate(267.5, 200.0, 277.5)
    world = g.Group([floor] + walls + [light, dragon])
    return g.SceneDef(world=world, lights=[light], config={})
