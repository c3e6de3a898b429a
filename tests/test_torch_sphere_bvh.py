"""The spheres' BVH that the vertex hit kernel KV1 walks (ops/vertex.py:
sphere_bvh, csrc/vertex_hit.cu) on the CPU.

The kernel runs only on the card, where scripts/vertex_parity.py and
scripts/kv1_walk_check.py hold it against the plain loop bit for bit.
Here:

- the tree in the tables of golden_monkey (461 spheres), tonemap_test
  (12), `test` (one sphere), cornell_smoke (none) and a field of affine
  (rotated, non-uniformly scaled) spheres: every sphere id in exactly one
  leaf, every node box holding its children's boxes and its spheres'
  exact bounds (|r|, or the row norms of the forward matrix) widened by
  the pad, at most one leaf's worth of spheres making a one-leaf tree, the
  header's offsets reading back what `sphere_bvh` built;
- `walk`, an emulation of the kernel's walk in float32 torch ops (its
  slab test, margin, cull, near-first order, stack and winner rule) in
  which each tested sphere's t is the plain version's own
  (ops/intersect.py:intersect_spheres on a one-sphere slice of the pack),
  so that the tree, the cull and the winner rule are what is under test:
  its (t, id) equal the plain loop's on every lane of camera and bounce
  rays of golden_monkey, rays from a sphere's surface, grazing rays along
  box faces and tangent to spheres, rays through the hollow glass pairs,
  two spheres planted with one centre and radius, equal-t hits planted in
  two leaves, and the affine field.
"""
import math
from unittest import mock

import numpy as np
import pytest
import torch

from rust_raytracer_torch import models
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.ops import vertex
from rust_raytracer_torch.render import integrator as tint
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.scene import graph as tg

torch.set_num_threads(2)

F32 = torch.float32
T_MIN = tint.T_MIN
# csrc/vertex_hit.cu's constants
K_OUT, K_IN, TINY_DIR = 1.0 + 2.0 ** -20, 1.0 - 2.0 ** -20, 2.0 ** -100


def _tree(f, i):
    """(node_f (n, BVH_F), node_i (n, BVH_I), leaf ids) of the tables, read
    through the header as the kernel reads them."""
    nb = int(i[vertex.H_NBVH])
    fo, io = int(i[vertex.H_F_BVH]), int(i[vertex.H_I_BVH])
    node_f = f[fo:fo + nb * vertex.BVH_F].reshape(nb, vertex.BVH_F)
    node_i = i[io:io + nb * vertex.BVH_I].reshape(nb, vertex.BVH_I).astype(np.int64)
    leaf = i[io + nb * vertex.BVH_I:io + nb * vertex.BVH_I + int(i[vertex.H_NS])]
    return node_f, node_i, leaf.astype(np.int64)


def _compiled(scene):
    pack, static = tcompiler.compile_scene(scene, "cpu")
    return pack, static


def affine_field(g, n=40, seed=5):
    """n spheres under random rotations and non-uniform scales on a plane,
    with a floor: every sphere of the scene takes the affine rows."""
    rng = np.random.default_rng(seed)
    mat = g.Lambertian(g.Constant((0.5, 0.5, 0.5)))
    items = [g.Plane((0, 0, 0), (8, 0, 0), (0, 0, -8), mat)]
    for k in range(n):
        s = g.Transform(g.Sphere((0.0, 0.0, 0.0), float(rng.uniform(0.1, 0.4)), mat))
        s = s.scale(*rng.uniform(0.5, 2.0, size=3)).rotate_z(float(rng.uniform(0, 90)))
        s = s.rotate_x(float(rng.uniform(0, 90))).translate(
            float(rng.uniform(-4, 4)), float(rng.uniform(0.2, 1.0)), float(rng.uniform(-4, 4)))
        items.append(s)
    sky = g.Sky(g.Constant((0.5, 0.7, 1.0)))
    return g.SceneDef(world=g.Group(items + [sky]), lights=[sky], config={})


def field_scene(g, spheres):
    """A scene of (centre, radius) spheres, one material, under a sky."""
    mat = g.Lambertian(g.Constant((0.5, 0.5, 0.5)))
    sky = g.Sky(g.Constant((0.5, 0.7, 1.0)))
    items = [g.Sphere(tuple(float(x) for x in c), float(r), mat) for c, r in spheres]
    return g.SceneDef(world=g.Group(items + [sky]), lights=[sky], config={})


@pytest.fixture(scope="module")
def monkey():
    return _compiled(models.build("golden_monkey"))


# ---------------------------------------------------------------- the tree

def _bounds(pack):
    """Each sphere's exact centre and extent (float64 of the f32 rows)."""
    c = pack.sph_center.numpy().astype(np.float64)
    if pack.sph_inv.shape[0]:
        ext = np.linalg.norm(pack.sph_fwd.numpy().astype(np.float32).astype(np.float64), axis=2)
    else:
        ext = np.repeat(np.abs(pack.sph_radius.numpy().astype(np.float64))[:, None], 3, axis=1)
    return c, ext


def check_tree(pack, static):
    f, i = vertex.table_arrays(pack, static)
    ns = pack.sph_center.shape[0]
    node_f, node_i, leaf = _tree(f, i)
    assert int(i[vertex.H_F_BVH]) % 4 == 0 and int(i[vertex.H_I_BVH]) % 2 == 0
    sph = f[int(i[vertex.H_F_SPH]):int(i[vertex.H_F_SPH]) + ns * vertex.SPH_F].reshape(
        ns, vertex.SPH_F)
    mats = ((sph[:, 4:13].reshape(ns, 3, 3), sph[:, 13:22].reshape(ns, 3, 3))
            if pack.sph_inv.shape[0] else ())
    want = vertex.sphere_bvh(sph[:, 0:3], sph[:, 3], *mats)
    np.testing.assert_array_equal(node_f, want[0])
    np.testing.assert_array_equal(node_i, want[1])
    np.testing.assert_array_equal(leaf, want[2])
    if ns == 0:
        assert node_f.shape[0] == 0
        return node_f, node_i, leaf
    assert sorted(leaf.tolist()) == list(range(ns))
    c, ext = _bounds(pack)
    pad = vertex.BOX_PAD * (np.abs(c).max(axis=1) + ext.max(axis=1))
    lo, hi = node_f[:, 0:3].astype(np.float64), node_f[:, 3:6].astype(np.float64)
    assert np.isfinite(node_f).all() and (node_f[:, 9] > 0).all() and (node_f[:, 10] >= 0).all()

    def spheres(k):
        a, b = node_i[k]
        if a < 0:
            return leaf[-1 - a:-1 - a + b].tolist()
        for child in (a, b):
            assert child > k
            assert (lo[child] >= lo[k]).all() and (hi[child] <= hi[k]).all()
        return spheres(a) + spheres(b)

    assert sorted(spheres(0)) == list(range(ns))
    for k in range(node_f.shape[0]):
        ids = spheres(k)
        assert (lo[k] <= c[ids] - ext[ids] - pad[ids, None]).all()
        assert (hi[k] >= c[ids] + ext[ids] + pad[ids, None]).all()
        if node_i[k, 0] < 0:
            assert 1 <= node_i[k, 1] <= vertex.LEAF_SPHERES
    if ns <= vertex.LEAF_SPHERES:
        assert node_i.tolist() == [[-1, ns]]
    return node_f, node_i, leaf


@pytest.mark.parametrize("name", ["golden_monkey", "tonemap_test", "test", "cornell_smoke",
                                  "affine_field"])
def test_tree(name):
    scene = affine_field(tg) if name == "affine_field" else models.build(name)
    pack, static = _compiled(scene)
    node_f, node_i, _ = check_tree(pack, static)
    ns = pack.sph_center.shape[0]
    assert ns == {"golden_monkey": 461, "tonemap_test": 12, "test": 1, "cornell_smoke": 0,
                  "affine_field": 40}[name]
    if name == "golden_monkey":
        # median splits of 461 down to leaves of 3-4: 128 leaves, 7 levels
        assert node_f.shape[0] == 255 and (node_i[:, 0] < 0).sum() == 128


def test_one_leaf_and_no_sphere_tables():
    one = vertex.sphere_bvh(np.zeros((4, 3), np.float32), np.full(4, 0.5, np.float32))
    assert one[1].tolist() == [[-1, 4]] and one[2].tolist() == [0, 1, 2, 3]
    none = vertex.sphere_bvh(np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
    assert [x.shape[0] for x in none] == [0, 0, 0]
    # a tree deeper than the walk's stack is refused
    with mock.patch.object(vertex, "BVH_STACK", 3), pytest.raises(ValueError, match="deeper"):
        vertex.sphere_bvh(np.random.default_rng(0).random((64, 3)).astype(np.float32),
                          np.full(64, 0.01, np.float32))


# ---------------------------------------------------------------- the walk

def candidates(pack, org, dirn):
    """(n, ns) f32: each sphere's t for each ray, from intersect_spheres on
    a one-sphere slice of the pack (inf where it misses)."""
    n, ns, dev = org.shape[0], pack.sph_center.shape[0], org.device
    affine = pack.sph_inv.shape[0] > 0
    tl = torch.full((n,), T_MIN, dtype=F32, device=dev)
    inf = torch.full((n,), math.inf, dtype=F32, device=dev)
    out = torch.empty((n, ns), dtype=F32, device=dev)
    for j in range(ns):
        one = pack._replace(
            sph_center=pack.sph_center[j:j + 1], sph_radius=pack.sph_radius[j:j + 1],
            sph_inv=pack.sph_inv[j:j + 1] if affine else pack.sph_inv,
            sph_fwd=pack.sph_fwd[j:j + 1] if affine else pack.sph_fwd)
        t, _ = tisect.intersect_spheres(one, org, dirn, tl, inf)
        out[:, j] = t
    return out


def _len2(x, y, z):
    return x * x + y * y + z * z


def _enter(row, o, inv, best):
    """csrc/vertex_hit.cu:node_enter over lanes: (entered, entry t)."""
    m = row[:, 9] * _len2(o[:, 0] - row[:, 6], o[:, 1] - row[:, 7], o[:, 2] - row[:, 8]) \
        + row[:, 10]
    lo = [(row[:, a] - m - o[:, a]) * inv[:, a] for a in range(3)]
    hi = [(row[:, 3 + a] + m - o[:, a]) * inv[:, a] for a in range(3)]
    near = torch.fmax(torch.fmax(torch.fmin(lo[0], hi[0]), torch.fmin(lo[1], hi[1])),
                      torch.fmin(lo[2], hi[2]))
    far = torch.fmin(torch.fmin(torch.fmax(lo[0], hi[0]), torch.fmax(lo[1], hi[1])),
                     torch.fmax(lo[2], hi[2]))
    k_in, k_out, t_min = (torch.tensor(x, dtype=F32, device=o.device)
                          for x in (K_IN, K_OUT, T_MIN))
    near = near * torch.where(near >= 0, k_in, k_out)
    far = far * torch.where(far >= 0, k_out, k_in)
    enter = torch.fmax(near, t_min)
    return enter <= torch.fmin(far, best), enter


def walk(f, i, org, dirn, cand):
    """The kernel's walk of the tables' sphere BVH over (n, 3) f32 rays, a
    step of every lane at a time, with each sphere's t from `cand`:
    (t, id, node visits, sphere tests) a lane."""
    n, dev, i64 = org.shape[0], org.device, torch.int64
    node_f, node_i, leaf = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                            for x in _tree(f, i))
    tiny = torch.tensor(TINY_DIR, dtype=F32, device=dev)
    inv = 1.0 / torch.where(dirn.abs() >= tiny, dirn, torch.copysign(tiny, dirn))
    best = torch.full((n,), math.inf, dtype=F32, device=dev)
    bid = torch.full((n,), -1, dtype=i64, device=dev)
    visits = torch.zeros(n, dtype=i64, device=dev)
    tests = torch.zeros(n, dtype=i64, device=dev)
    node = torch.full((n,), 0 if int(i[vertex.H_NS]) else -1, dtype=i64, device=dev)
    stack_n = torch.zeros((n, vertex.BVH_STACK), dtype=i64, device=dev)
    stack_t = torch.zeros((n, vertex.BVH_STACK), dtype=F32, device=dev)
    sp = torch.zeros(n, dtype=i64, device=dev)
    while bool((node >= 0).any()):
        lanes = torch.nonzero(node >= 0).flatten()
        visits[lanes] += 1
        kids = node_i[node[lanes]]
        at_leaf = kids[:, 0] < 0
        lf, first, count = lanes[at_leaf], -1 - kids[at_leaf, 0], kids[at_leaf, 1]
        for k in range(vertex.LEAF_SPHERES):
            has = k < count
            ln, si = lf[has], leaf[first[has] + k]
            t = cand[ln, si]
            take = (t < best[ln]) | ((t == best[ln]) & (si < bid[ln]))
            best[ln[take]], bid[ln[take]] = t[take], si[take]
        tests[lf] += count
        node[lf] = -1
        inner, kl, kr = lanes[~at_leaf], kids[~at_leaf, 0], kids[~at_leaf, 1]
        in_l, el = _enter(node_f[kl], org[inner], inv[inner], best[inner])
        in_r, er = _enter(node_f[kr], org[inner], inv[inner], best[inner])
        both, left_first = in_l & in_r, el <= er
        none = torch.full_like(kr, -1)
        node[inner] = torch.where(both, torch.where(left_first, kl, kr),
                                  torch.where(in_l, kl, torch.where(in_r, kr, none)))
        pb = inner[both]
        stack_n[pb, sp[pb]] = torch.where(left_first, kr, kl)[both]
        stack_t[pb, sp[pb]] = torch.where(left_first, er, el)[both]
        sp[pb] += 1
        while True:
            pop = torch.nonzero((node < 0) & (sp > 0)).flatten()
            if pop.numel() == 0:
                break
            sp[pop] -= 1
            keep = ~(stack_t[pop, sp[pop]] > best[pop])
            node[pop[keep]] = stack_n[pop[keep], sp[pop[keep]]]
    return best, bid.to(torch.int32), visits, tests


def assert_walk_equals_loop(pack, static, org, dirn):
    """The emulated walk's (t, id) equal intersect_spheres' on every lane;
    returns the walk's (visits, tests) a lane."""
    org, dirn = org.to(F32).contiguous(), dirn.to(F32).contiguous()
    n = org.shape[0]
    f, i = vertex.table_arrays(pack, static)
    t, sid, visits, tests = walk(f, i, org, dirn, candidates(pack, org, dirn))
    want_t, want_i = tisect.intersect_spheres(pack, org, dirn, torch.full((n,), T_MIN, dtype=F32),
                                              torch.full((n,), math.inf, dtype=F32))
    bad = ~((t == want_t) & (sid == want_i))
    assert not bool(bad.any()), (f"{int(bad.sum())} of {n} lanes differ: walk "
                                 f"{list(zip(t[bad][:4].tolist(), sid[bad][:4].tolist()))}, loop "
                                 f"{list(zip(want_t[bad][:4].tolist(), want_i[bad][:4].tolist()))}")
    return visits.double(), tests.double()


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def camera_rays(rng, n, position=(5.0, 2.0, 9.0), look_at=(0.0, 0.5, 0.0), half_fov=0.4,
                aperture=0.009):
    """n rays from a lens of radius `aperture` about `position` into a cone
    of half-angle `half_fov` about the view direction (monkey_render's
    camera: 50 mm at f/2.8)."""
    pos, look = np.array(position), np.array(look_at)
    w = (look - pos) / np.linalg.norm(look - pos)
    d = w + np.tan(half_fov) * rng.uniform(-1, 1, size=(n, 3))
    o = pos + aperture * rng.uniform(-1, 1, size=(n, 3))
    return torch.from_numpy(o).to(F32), torch.from_numpy(d).to(F32)


def first_hit_bounces(pack, org, dirn, rng):
    """Rays from the first hit of (org, dirn) on a sphere or the floor
    (y = 0, |x| and |z| up to 20, golden_monkey's), cosine-distributed
    about its normal; the lanes that hit neither are left out."""
    n = org.shape[0]
    t_s, i_s = tisect.intersect_spheres(pack, org, dirn, torch.full((n,), T_MIN, dtype=F32),
                                        torch.full((n,), math.inf, dtype=F32))
    t_f = torch.where(dirn[:, 1] < 0, -org[:, 1] / dirn[:, 1], torch.tensor(math.inf))
    on_floor = (org + dirn * t_f[:, None]).abs().amax(dim=1) <= 20.0
    t_f = torch.where(on_floor, t_f, torch.tensor(math.inf))
    t = torch.minimum(t_s, t_f)
    hit = torch.isfinite(t)
    pos = org + dirn * t[:, None]
    nrm = torch.zeros_like(pos)
    nrm[:, 1] = 1.0
    on_s = hit & (t_s <= t_f)
    c = pack.sph_center[i_s.clamp(min=0).long()]
    r = pack.sph_radius[i_s.clamp(min=0).long()]
    nrm[on_s] = ((pos - c) / r[:, None])[on_s]
    new = nrm + torch.from_numpy(_unit(rng, n)).to(F32)
    return pos[hit], new[hit]


def test_walk_golden_monkey_camera_and_bounce_rays(monkey):
    """Camera rays (aperture included) and their cosine bounces from the
    first hit: (t, id) equal to the loop on every lane, and the walk tests
    a few spheres a ray where the loop tests 461."""
    pack, static = monkey
    rng = np.random.default_rng(23)
    org, dirn = camera_rays(rng, 3000)
    visits, tests = assert_walk_equals_loop(pack, static, org, dirn)
    b_org, b_dirn = first_hit_bounces(pack, org, dirn, rng)
    assert b_org.shape[0] > 1500
    b_visits, b_tests = assert_walk_equals_loop(pack, static, b_org, b_dirn)
    for v, t in ((visits, tests), (b_visits, b_tests)):
        assert float(t.mean()) < 10 and float(v.mean()) < 30
        assert int(t.max()) < 60


def _t(a, dev):
    return torch.from_numpy(np.asarray(a)).to(F32).to(dev)


def surface_rays(pack, rng, n):
    """n rays from points on random spheres' surfaces (rounded to f32, so
    just in or out), in random directions."""
    dev = pack.sph_center.device
    ids = torch.from_numpy(rng.integers(0, pack.sph_center.shape[0], n)).to(dev)
    c, r = pack.sph_center[ids], pack.sph_radius[ids]
    return c + _t(_unit(rng, n), dev) * r[:, None], _t(_unit(rng, n), dev)


def grazing_rays(pack, rng, n):
    """2n rays: n along a face of a random sphere's exact box (o_x = c_x +-
    |r| and d_x = 0, or the same on y or z), from 0.5-30 away; n tangent to
    a random sphere at a random point, from 0.05-30 away."""
    dev = pack.sph_center.device
    ids = torch.from_numpy(rng.integers(0, pack.sph_center.shape[0], n)).to(dev)
    c, r = pack.sph_center[ids], pack.sph_radius[ids].abs()
    axis = torch.from_numpy(rng.integers(0, 3, n)).to(dev)
    lanes = torch.arange(n, device=dev)
    face = c.clone()
    face[lanes, axis] += _t(rng.choice([-1.0, 1.0], n), dev) * r
    dirn = _t(_unit(rng, n), dev)
    dirn[lanes, axis] = 0.0
    org_face = face - dirn * _t(rng.uniform(0.5, 30.0, n), dev)[:, None]
    u = _t(_unit(rng, n), dev)
    p = c + u * r[:, None]
    tang = _t(_unit(rng, n), dev)
    tang = tang - u * (tang * u).sum(1, keepdim=True)
    org_tan = p - tang * _t(rng.uniform(0.05, 30.0, n), dev)[:, None]
    return torch.cat([org_face, org_tan]), torch.cat([dirn, tang])


def test_walk_rays_from_sphere_surfaces(monkey):
    """Rays from points on a sphere's surface, outward and inward: the t_min
    case, and the far side of the glass shells."""
    pack, static = monkey
    assert_walk_equals_loop(pack, static, *surface_rays(pack, np.random.default_rng(29), 2000))


def test_walk_grazing_rays(monkey):
    """Rays along the faces of the spheres' exact boxes with a zero
    direction component, and rays tangent to a sphere at random points,
    from near and from far."""
    pack, static = monkey
    assert_walk_equals_loop(pack, static, *grazing_rays(pack, np.random.default_rng(31), 1500))


def test_walk_hollow_glass_pairs(monkey):
    """Rays at the glass pairs (radius 0.2 and -0.18 about one centre) from
    outside, from within the shell and from inside the inner sphere."""
    pack, static = monkey
    radius = pack.sph_radius.numpy()
    inner = np.flatnonzero(radius < 0)
    assert len(inner) > 0
    rng = np.random.default_rng(37)
    n = 1500
    ids = rng.choice(inner, n)
    c = pack.sph_center[ids]
    depth = torch.from_numpy(rng.choice([0.1, 0.19, 0.5, 3.0], n)).to(F32)
    org = c + torch.from_numpy(_unit(rng, n)).to(F32) * depth[:, None]
    dirn = torch.where(torch.from_numpy(rng.random(n) < 0.5)[:, None], c - org,
                       torch.from_numpy(_unit(rng, n)).to(F32))
    assert_walk_equals_loop(pack, static, org, dirn)


def same_sphere_twice():
    """(centre, radius) of 31 spheres: 30 small ones on a plane, of which
    id 7 and id 30 have one centre and radius."""
    rng = np.random.default_rng(41)
    spheres = [((x, 0.2, z), 0.2) for x, z in rng.uniform(-6, 6, size=(30, 2))]
    spheres[7] = ((0.5, 0.2, 0.5), 0.3)
    return spheres + [((0.5, 0.2, 0.5), 0.3)]


def mirrored_pair(lower_first):
    """(centre, radius) of 26 spheres, each mirrored in the plane x = 0 by
    another, among them an overlapping pair at x = +-0.6 (ids 0 and 1 with
    the one at +0.6 first, or ids 5 and 6 with it last), which the first
    split puts in two leaves."""
    rng = np.random.default_rng(43)
    others = []
    for x, z, z2 in zip(rng.uniform(1.0, 6.0, 12), rng.uniform(-3, 3, 12), rng.uniform(-3, 3, 12)):
        others += [((x, 0.2, z), 0.15), ((-x, 0.2, z2), 0.15)]
    pair = [((0.6, 0.2, -2.0), 0.7), ((-0.6, 0.2, -2.0), 0.7)]
    return pair + others if lower_first else others[:5] + pair[::-1] + others[5:]


def mirror_plane_rays(rng, n):
    """n rays in the plane x = 0 towards -z, through the mirrored pair."""
    org = torch.zeros((n, 3), dtype=F32)
    org[:, 1] = torch.from_numpy(rng.uniform(0.0, 1.5, n)).to(F32)
    org[:, 2] = 3.0
    dirn = torch.zeros((n, 3), dtype=F32)
    dirn[:, 1] = torch.from_numpy(rng.uniform(-0.3, 0.1, n)).to(F32)
    dirn[:, 2] = -1.0
    return org, dirn


def test_walk_same_sphere_twice_gives_the_lower_id():
    """Two spheres of one centre and radius at different ids in a field of
    others: every ray that hits them takes the lower id, as the loop."""
    pack, static = _compiled(field_scene(tg, same_sphere_twice()))
    org, dirn = camera_rays(np.random.default_rng(41), 800, position=(3.0, 2.0, 5.0),
                            look_at=(0.5, 0.2, 0.5), half_fov=0.08)
    assert_walk_equals_loop(pack, static, org, dirn)
    f, i = vertex.table_arrays(pack, static)
    _, sid, _, _ = walk(f, i, org, dirn, candidates(pack, org, dirn))
    assert int((sid == 7).sum()) > 100 and int((sid == 30).sum()) == 0


@pytest.mark.parametrize("lower_first", [True, False])
def test_walk_equal_t_in_two_leaves(lower_first):
    """Two spheres mirrored in the plane x = 0 (equal arithmetic, so equal
    t bit for bit for a ray in that plane), placed in different leaves:
    the walk takes the lower id whichever leaf it enters first."""
    spheres = mirrored_pair(lower_first)
    pack, static = _compiled(field_scene(tg, spheres))
    f, i = vertex.table_arrays(pack, static)
    node_f, node_i, leaf = _tree(f, i)
    ids = [k for k, s in enumerate(spheres) if s[1] == 0.7]
    leaf_of = {}
    for a, b in node_i:
        if a < 0:
            for s in leaf[-1 - a:-1 - a + b]:
                leaf_of[int(s)] = (a, b)
    assert len(ids) == 2 and leaf_of[ids[0]] != leaf_of[ids[1]]
    org, dirn = mirror_plane_rays(np.random.default_rng(43), 600)
    cand = candidates(pack, org, dirn)
    tie = (cand[:, ids[0]] == cand[:, ids[1]]) & torch.isfinite(cand[:, ids[0]])
    assert int(tie.sum()) > 100
    assert_walk_equals_loop(pack, static, org, dirn)
    _, sid, _, _ = walk(f, i, org, dirn, cand)
    won = sid[tie]
    assert int((won == max(ids)).sum()) == 0 and int((won == min(ids)).sum()) > 100


def test_walk_affine_field():
    """A field of rotated, non-uniformly scaled spheres (the affine rows):
    rays from above and rays tangent to their bounding spheres."""
    pack, static = _compiled(affine_field(tg))
    assert pack.sph_inv.shape[0] == 40
    rng = np.random.default_rng(47)
    org, dirn = camera_rays(rng, 1500, position=(6.0, 4.0, 8.0), look_at=(0.0, 0.5, 0.0),
                            half_fov=0.5)
    visits, tests = assert_walk_equals_loop(pack, static, org, dirn)
    assert float(tests.mean()) < 20
    # from the first hits: the normal is a sphere's, not the ellipsoid's,
    # which only tilts the cosine lobe
    b_org, b_dirn = first_hit_bounces(pack, org, dirn, rng)
    assert_walk_equals_loop(pack, static, b_org, b_dirn)


# ---------------------------------------------------------------- the counter

@pytest.mark.parametrize("name", ["tonemap_test", "cornell_smoke"])
def test_fused_vertex_hands_kv1_its_counter_row(monkeypatch, name):
    """With the pool step's counters, KV1 gets slots 0-1 of their KV1 row in
    a scene with spheres and no counter in one without (`vertex._launch`
    is a recorder: nothing runs)."""
    from rust_raytracer_torch.core import rng as trng
    from test_torch_free_flight import Recorder, _walk_recorded

    pack, static = _compiled(models.build(name))
    n = 64
    org, dirn = torch.zeros((n, 3)), torch.ones((n, 3))
    ctx = trng.Ctx(torch.arange(n), torch.zeros(n, dtype=torch.int64), 0, 1)
    monkeypatch.setattr(vertex, "launches", dict(vertex.launches))
    for counters in (vertex.new_counters(), None):
        rec = Recorder()
        monkeypatch.setattr(vertex, "_launch", rec)
        _walk_recorded(monkeypatch, rec)
        vertex.fused_vertex(pack, static, org, dirn, ctx, 0.25, torch.ones(n, dtype=torch.bool),
                            "auto", T_MIN, counters)
        name0, ptrs = rec.calls[0]
        # KV1's pointers: ftab, itab, org, dirn, alive, counts, then its outputs
        assert name0 == "rrt_vertex_hit" and len(ptrs) == 11
        if counters is not None and pack.sph_center.shape[0]:
            assert ptrs[5].data_ptr() == counters[vertex.ROW_KV1].data_ptr()
            assert tuple(ptrs[5].shape) == (2,)
        else:
            assert ptrs[5] is None


@pytest.mark.parametrize("name", ["test", "cornell_smoke"])
def test_pool_reads_kv1_counts_in_a_scene_with_spheres(name):
    """run_pool reads the KV1 row into RenderMetrics once its loop has
    ended: 0 on the CPU (the plain loop walks no tree) in a scene with
    spheres, reported by summary(); None without spheres, left out."""
    from rust_raytracer_torch.render import pool
    from rust_raytracer_torch.render.camera import Camera
    from rust_raytracer_torch.utils.metrics import RenderMetrics

    pack, static = _compiled(models.build(name))
    camera = Camera(image_width=8, aspect_ratio=1.0, samples_per_pixel=1, max_depth=2,
                    position=(0.0, 0.5, 3.0), look_at=(0.0, 0.0, 0.0), focal_length=35.0)
    step = pool.make_step(pack, static, camera, 64, 1, 0)
    (counter,) = step.counters
    assert tuple(counter.shape) == (vertex.COUNTER_ROWS, vertex.VOLUME_SLOTS) == (4, 32)
    counter.fill_(5)
    metrics = RenderMetrics()
    pool.run_pool(pack, static, camera, 64, 1, 64, "cpu", metrics=metrics, step=step)
    assert counter[vertex.ROW_KV1].tolist() == [0] * vertex.VOLUME_SLOTS
    if pack.sph_center.shape[0]:
        assert metrics.kv1_node_visits == metrics.kv1_sphere_tests == 0
        assert metrics.summary()["kv1_sphere_tests"] == 0
    else:
        assert metrics.kv1_node_visits is None and metrics.kv1_sphere_tests is None
        assert "kv1_sphere_tests" not in metrics.summary()
