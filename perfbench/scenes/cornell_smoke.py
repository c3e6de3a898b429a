"""The `cornell_smoke` scene as the reference builds it: the reference's
scene/cornell_smoke.rs (a small Cornell box centred on the origin, an
area light, two boxes of constant-density medium, black smoke and white
fog, both of density 0.15), a frozen copy of the program's built-in
`cornell_smoke` in the reference's own scene description.  It has no
triangle: both volume boundaries are oriented boxes."""
from perfbench.reference import graph as g
from perfbench.reference import volumes

SOURCE_SCENE = "cornell_smoke"
CAMERA = dict(aspect_ratio=1.0, focal_length=35.0, position=(0.0, 0.0, 110.0),
              look_at=(0.0, 0.0, 0.0))


def build(config: dict) -> g.SceneDef:
    volumes.install()
    mat_white = g.Lambertian(g.Constant((0.73, 0.73, 0.73)))
    mat_green = g.Lambertian(g.Constant((0.12, 0.45, 0.15)))
    mat_red = g.Lambertian(g.Constant((0.65, 0.05, 0.05)))
    mat_light = g.Emissive(g.Constant((15.0, 15.0, 15.0)))
    mat_smoke = volumes.Isotropic(g.Constant((0.0, 0.0, 0.0)))
    mat_fog = volumes.Isotropic(g.Constant((1.0, 1.0, 1.0)))

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

    smoke = volumes.Volume(box1, mat_smoke, 0.15)
    fog = volumes.Volume(box2, mat_fog, 0.15)
    world = g.Group([floor, ceiling, back, left, right, light, smoke, fog])
    return g.SceneDef(world=world, lights=[light], config={})
