"""The `cornell` scene as the reference builds it: the reference's
scene/cornell_box.rs and scenes/cornell (planes, a box of six planes, a
glass sphere, an area light), a frozen copy of the program's built-in
`cornell` in the reference's own scene description."""
from perfbench.reference import graph as g

SOURCE_SCENE = "cornell"


def shell():
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


CAMERA = dict(aspect_ratio=1.0, focal_length=33.0, position=(277.5, 277.5, -800.0),
              look_at=(277.5, 277.5, 0.0))


def build(config: dict) -> g.SceneDef:
    mat_white, walls = shell()
    checker = g.Checker(g.Constant(0.0), g.Constant(1.0), 0.25)
    mat_checker = g.Glossy(g.Constant((0.95, 0.95, 0.95)), checker, 1.5)
    mat_light = g.Emissive(g.Constant((15.0, 15.0, 15.0)))
    mat_glass = g.Dielectric(1.5)
    floor = g.Plane((277.5, 0, 277.5), (277.5, 0, 0), (0, 0, -277.5), mat_checker)
    light = g.Plane((277.5, 554.9, 277.5), (-65, 0, 0), (0, 0, -52.5), mat_light,
                    render_backface=True)
    box = g.Transform(g.Box((0, 0, 0), (165, 330, 165), mat_white))
    box.translate(82.5, 165, 82.5).rotate_y(18).translate(265, 0, 295)
    ball = g.Sphere((212.5, 82.51, 147.5), 82.5, mat_glass)
    world = g.Group([floor] + walls + [light, box, ball])
    return g.SceneDef(world=world, lights=[light, ball], config={})
