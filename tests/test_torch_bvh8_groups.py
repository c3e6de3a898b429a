"""The BVH8 walk's grouped leaf test (csrc/bvh8_traverse.cu:warp_leaf_test)
in torch ops (ops/bvh8.py:leaf_test_plain) against the full 128-slot scan
(threaded.mt_rows, then the first slot at the minimum): t bit for bit and
the slot of every hit, on every (ray, cluster) pair of the test scenes,
for bounce-like rays, rays grazing triangle edges, planted equal-t ties
and the t_max values the renderers pass; the leaf tables
(scene/pack.py:bvh8_leaf_tables) on clusters with groups of padding; the
K1 counter through the pool and its benchmark reader."""
from __future__ import annotations

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

from rust_raytracer_torch.ops import bvh8 as tbvh8
from rust_raytracer_torch.ops import threaded
from rust_raytracer_torch.ops import vertex
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.scene import graph as tg
from rust_raytracer_torch.scene import pack as tpack
from rust_raytracer_torch.utils.metrics import RenderMetrics

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_scene import SCENES  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = float("inf")


def full_scan(pack, org, dirn, best, cl):
    """The 128-slot scan the grouped test must equal: (least t < best,
    first slot at it)."""
    rows = pack.tri_rows.view(-1, 128, 12)[cl]
    tt = threaded.mt_rows(org, dirn, rows, best)
    t = tt.min(dim=1).values
    first = torch.where(tt == t[:, None], torch.arange(128), 128).min(dim=1).values
    return t, first


def assert_equal_to_full_scan(pack, org, dirn, best, cl):
    """(t, slot) of leaf_test_plain equal the full scan's: t bit for bit,
    the slot wherever t < best.  Returns (hits, groups tested)."""
    t_f, s_f = full_scan(pack, org, dirn, best, cl)
    t_g, s_g, groups = tbvh8.leaf_test_plain(pack, org, dirn, best, cl)
    assert torch.equal(t_f.view(torch.int32), t_g.view(torch.int32))
    hit = t_f < best
    assert torch.equal(s_f[hit], s_g[hit])
    return int(hit.sum()), groups


def all_pairs(pack, org, dirn, best):
    """Every ray against every cluster."""
    nc = pack.tri_rows.shape[0] // 128
    n = org.shape[0]
    return (org.repeat_interleave(nc, 0), dirn.repeat_interleave(nc, 0),
            best.repeat_interleave(nc, 0), torch.arange(nc).repeat(n))


def real_rows(pack):
    rows = pack.tri_rows.numpy()
    return rows, np.nonzero((rows[:, 3:9] != 0).any(1))[0]


def bounce_rays(pack, n, rng):
    """Origins on the scene's triangles, uniform directions: a bounce."""
    rows, real = real_rows(pack)
    r = rows[rng.choice(real, n)].astype(np.float64)
    a, b = rng.random(n), rng.random(n)
    flip = a + b > 1
    a[flip], b[flip] = 1 - a[flip], 1 - b[flip]
    org = r[:, 0:3] + a[:, None] * r[:, 3:6] + b[:, None] * r[:, 6:9]
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(org.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


def grazing_rays(pack, n, rng):
    """Rays through a point on a triangle's edge or at its vertex v0, in
    its plane (along the edge, or across it) tilted by 1e-9 to 1e-2, from
    0.1 to ~1600 units away: where Möller–Trumbore's rounding decides a
    hit, at the border of the triangle's box."""
    rows, real = real_rows(pack)
    r = rows[rng.choice(real, n)].astype(np.float64)
    v0, e1, e2 = r[:, 0:3], r[:, 3:6], r[:, 6:9]
    kind = rng.integers(0, 3, n)[:, None]
    a = rng.random(n)[:, None]
    p = np.where(kind == 0, v0 + a * e1,
                 np.where(kind == 1, v0 + a * e2, v0 + a * e1 + (1 - a) * e2))
    at_vertex = rng.random(n) < 0.3
    p[at_vertex] = v0[at_vertex]
    normal = np.cross(e1, e2)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    edge = np.where(kind == 0, e1, np.where(kind == 1, e2, e2 - e1))
    edge /= np.linalg.norm(edge, axis=1, keepdims=True)
    across = rng.normal(size=(n, 3))
    across -= (across * normal).sum(1, keepdims=True) * normal
    across /= np.linalg.norm(across, axis=1, keepdims=True)
    d = np.where(rng.random(n)[:, None] < 0.5, edge, across)
    d += (10.0 ** rng.uniform(-9, -2, n) * rng.choice([-1, 1], n))[:, None] * normal
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = p - (10.0 ** rng.uniform(-1, 3.2, n))[:, None] * d
    return torch.from_numpy(org.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


@pytest.fixture(scope="module")
def packs():
    return {name: tpack.from_numpy(tcompiler.compile_numpy(SCENES[name](tg))[0], (), "cpu")
            for name in ("mini_dragon", "soup")}


@pytest.mark.parametrize("rays", ["bounce", "grazing"])
@pytest.mark.parametrize("name", ["mini_dragon", "soup"])
def test_grouped_leaf_test_equals_full_scan(packs, name, rays):
    pack = packs[name]
    rng = np.random.default_rng(21)
    org, dirn = (bounce_rays if rays == "bounce" else grazing_rays)(pack, 1500, rng)
    best = torch.full((org.shape[0],), 3.4e38)
    o, d, b, cl = all_pairs(pack, org, dirn, best)
    hits, groups = assert_equal_to_full_scan(pack, o, d, b, cl)
    assert hits > 500
    # the groups save work: fewer than 4 a visit, none of padding alone
    assert groups.float().mean() < 3.0
    real_groups = (pack.bvh8_leaf_box[..., 0] <= pack.bvh8_leaf_box[..., 3]).sum(1)
    assert (groups <= real_groups[cl]).all()


@pytest.mark.parametrize("name", ["mini_dragon", "soup"])
def test_grouped_leaf_test_at_the_walks_t_max(packs, name):
    """t_max as the renderers pass it: 0 (a dead lane), +inf (clamped to
    3.4e38, the kernel's best), 3.4e38, and capped short of the hit."""
    pack = packs[name]
    org, dirn = bounce_rays(pack, 1000, np.random.default_rng(5))
    o, d, _, cl = all_pairs(pack, org, dirn, torch.zeros(org.shape[0]))
    t_hit, _ = full_scan(pack, o, d, torch.full((o.shape[0],), 3.4e38), cl)
    for t_max in (torch.zeros_like(t_hit), torch.full_like(t_hit, INF),
                  torch.full_like(t_hit, 3.4e38),
                  torch.where(torch.isinf(t_hit), torch.full_like(t_hit, INF), t_hit * 0.5)):
        best = torch.clamp(t_max, max=3.4e38)
        hits, groups = assert_equal_to_full_scan(pack, o, d, best, cl)
        if not t_max.any():
            assert hits == 0 and int(groups.sum()) == 0


def triangle_rows(v0, v1, v2):
    """(n, 12) rows of triangles given by their vertices."""
    v0, v1, v2 = (np.asarray(v, np.float32).reshape(-1, 3) for v in (v0, v1, v2))
    rows = np.zeros((v0.shape[0], 12), np.float32)
    rows[:, 0:3], rows[:, 3:6], rows[:, 6:9] = v0, v1 - v0, v2 - v0
    return rows


def cluster_pack(clusters):
    """A pack-like object of the leaf test's tables over clusters given as
    (k <= 128, 12) rows each, padded with zero rows."""
    rows = np.zeros((len(clusters) * 128, 12), np.float32)
    for c, r in enumerate(clusters):
        rows[c * 128:c * 128 + r.shape[0]] = r
    leaf, box = tpack.bvh8_leaf_tables(torch.from_numpy(rows))
    return types.SimpleNamespace(tri_rows=torch.from_numpy(rows), bvh8_leaf_rows=leaf,
                                 bvh8_leaf_box=box)


def leaf_perm(pack):
    """Each cluster's slots in leaf row order (the rows' column 10)."""
    return pack.bvh8_leaf_rows.view(torch.int32)[:, 10].view(-1, 128).numpy()


def soup_rows(n, rng, lo=-1.0, hi=1.0):
    c = rng.uniform(lo, hi, (n, 1, 3))
    v = c + rng.normal(0, 0.1, (n, 3, 3))
    return triangle_rows(v[:, 0], v[:, 1], v[:, 2])


@pytest.mark.parametrize("copies", [2, 40])
def test_planted_equal_t_ties(copies):
    """Copies of one triangle at scattered slots of a cluster (2: both in
    one group, as their centroids are one Morton code; 40: across two
    groups at least) among random triangles, rays through it from both
    sides: the lowest slot of the copies wins, as in the full scan."""
    rng = np.random.default_rng(copies)
    tri = triangle_rows([0.0, 0.0, 0.0], [0.5, 0.0, 0.1], [0.0, 0.5, 0.1])
    tri[:, 9] = 1.0  # hit from the back too
    rows = soup_rows(128, rng)
    slots = np.sort(rng.choice(128, copies, replace=False))
    rows[slots] = tri
    pack = cluster_pack([rows])
    pos = np.argsort(leaf_perm(pack)[0])[slots]
    assert len(set(pos // 32)) == (1 if copies == 2 else 2)
    n = 512
    target = torch.from_numpy(rng.uniform(0.02, 0.2, (n, 1)) * np.float32([[1.0, 1.0, 0.4]]))
    d = rng.normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2]) + 0.2
    d *= rng.choice([-1, 1], n)[:, None]
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    org = (target.float() - 3.0 * d).contiguous()
    best = torch.full((n,), 3.4e38)
    cl = torch.zeros(n, dtype=torch.int64)
    t_f, s_f = full_scan(pack, org, d, best, cl)
    t_g, s_g, _ = tbvh8.leaf_test_plain(pack, org, d, best, cl)
    assert torch.equal(t_f.view(torch.int32), t_g.view(torch.int32))
    on_copy = torch.from_numpy(np.isin(s_f.numpy(), slots))
    assert int(on_copy.sum()) > n // 2
    assert (s_g[on_copy] == int(slots[0])).all() and torch.equal(s_f, s_g)


@pytest.mark.parametrize("n_real", [96, 100, 32, 7])
def test_clusters_with_groups_of_padding(n_real):
    """A cluster of n_real triangles: its padding groups (one at 96, three
    at 32 or fewer) are inverted and never tested; the result is the full
    scan's."""
    rng = np.random.default_rng(n_real)
    pack = cluster_pack([soup_rows(n_real, rng), soup_rows(128, rng)])
    box = pack.bvh8_leaf_box.numpy()
    n_groups = -(-n_real // 32)
    assert (box[0, :n_groups, 0:3] <= box[0, :n_groups, 3:6]).all()
    assert (box[0, n_groups:, 0:3] > box[0, n_groups:, 3:6]).all()
    assert (leaf_perm(pack)[0, n_real:] == np.arange(n_real, 128)).all()
    n = 800
    org = torch.from_numpy(rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    for c in (0, 1):
        cl = torch.full((n,), c, dtype=torch.int64)
        hits, groups = assert_equal_to_full_scan(pack, org, d, torch.full((n,), 3.4e38), cl)
        assert hits > 0
        assert int(groups.max()) <= (n_groups if c == 0 else 4)


def test_leaf_tables_order_and_empty_scene():
    """Slots in Morton order of their centroids within the cluster, padding
    last; an empty scene has empty tables."""
    rows = np.zeros((128, 12), np.float32)
    # 8 triangles on a line along x, in reverse slot order
    xs = np.arange(8, dtype=np.float32)[::-1]
    rows[:8] = triangle_rows(np.stack([xs, 0 * xs, 0 * xs], 1), np.stack([xs + 0.5, 0 * xs, 0 * xs], 1),
                             np.stack([xs, 0.5 + 0 * xs, 0 * xs], 1))
    pack = cluster_pack([rows[:8]])
    perm = leaf_perm(pack)
    np.testing.assert_array_equal(perm[0, :8], np.arange(8)[::-1])
    np.testing.assert_array_equal(perm[0, 8:], np.arange(8, 128))
    box = pack.bvh8_leaf_box
    assert box[0, 0, 0] < 0.0 < 7.5 < box[0, 0, 3]
    leaf, box = tpack.bvh8_leaf_tables(torch.zeros((0, 12)))
    assert tuple(leaf.shape) == (0, 12) and tuple(box.shape) == (0, 4, 6)
    empty = tpack.empty_pack()
    assert tuple(empty.bvh8_leaf_rows.shape) == (0, 12)
    assert tuple(empty.bvh8_leaf_box.shape) == (0, 4, 6)


def test_pool_owns_the_k1_counter():
    """make_step gives each shard its counters, whose K1 row the walk adds to;
    run_pool zeroes them and reads the row into RenderMetrics once its loop
    has ended.  On the CPU the walk is the plain one: it counts nothing, and
    the summary leaves the counts out."""
    from rust_raytracer_torch.render import pool
    from rust_raytracer_torch.render.camera import Camera

    scene = SCENES["mini_dragon"](tg)
    pack, static = tcompiler.compile_scene(scene, "cpu")
    camera = Camera(image_width=8, aspect_ratio=1.0, samples_per_pixel=1, max_depth=2,
                    position=(278.0, 278.0, -800.0), look_at=(278.0, 278.0, 0.0),
                    focal_length=35.0)
    step = pool.make_step(pack, static, camera, 64, 1, 0)
    (counter,) = step.counters
    assert counter.dtype == torch.int64
    assert tuple(counter.shape) == (vertex.COUNTER_ROWS, vertex.VOLUME_SLOTS)
    counter.fill_(7)
    metrics = RenderMetrics()
    pool.run_pool(pack, static, camera, 64, 1, 64, "cpu", metrics=metrics, step=step)
    assert counter[vertex.ROW_K1].tolist() == [0] * vertex.VOLUME_SLOTS
    assert metrics.k1_leaf_visits == metrics.k1_groups_tested == 0
    assert "k1_leaf_visits" not in metrics.summary()
    metrics.k1_leaf_visits, metrics.k1_groups_tested = 10, 23
    assert metrics.summary()["k1_groups_tested"] == 23
    a, b = vertex.new_counters(), vertex.new_counters()
    a[vertex.ROW_K1, :2] = torch.tensor([3, 5])
    b[vertex.ROW_K1, :2] = torch.tensor([4, 6])
    a[vertex.ROW_VOLUME, 4], b[vertex.ROW_SPHERE, 9] = 2, 8
    a[vertex.ROW_KV1, :2] = torch.tensor([12, 4])
    b[vertex.ROW_KV1, :2] = torch.tensor([30, 9])
    assert pool.counter_sums(None, (a, b)) == {
        "volume_hits": 2, "sphere_hits": 8, "k1_leaf_visits": 7, "k1_groups_tested": 11,
        "kv1_node_visits": 42, "kv1_sphere_tests": 13}


def _reader(name):
    path = os.path.join(REPO, "perfbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_group_test_reader():
    """k1_group_test_pct.render: groups tested over 4 a leaf visit, summed
    over the traced units; None where the program has no such counter (the
    parent's RenderMetrics) or no leaf was visited."""
    read = _reader("k1_group_test_pct.render")
    unit = lambda c: types.SimpleNamespace(counters=c)
    ctx = types.SimpleNamespace(traced_units=[
        unit(RenderMetrics(k1_leaf_visits=1000, k1_groups_tested=2000)),
        unit(RenderMetrics(k1_leaf_visits=3000, k1_groups_tested=7000))])
    assert read(ctx) == pytest.approx(100.0 * 9000 / 16000)
    old = types.SimpleNamespace(lane_bounces=10, volume_hits=0)
    assert read(types.SimpleNamespace(traced_units=[unit(old)])) is None
    assert read(types.SimpleNamespace(traced_units=[unit(RenderMetrics())])) is None


def test_sphere_test_reader():
    """sphere_tests_per_bounce.render: KV1's sphere tests over the lane
    bounces, summed over the traced units; None where the program has no
    such counter (the parent's RenderMetrics), the scene has no sphere (the
    counter is None) or nothing was counted (the CPU's plain loop)."""
    read = _reader("sphere_tests_per_bounce.render")
    unit = lambda c: types.SimpleNamespace(counters=c)
    ctx = types.SimpleNamespace(traced_units=[
        unit(RenderMetrics(lane_bounces=1000, kv1_node_visits=9000, kv1_sphere_tests=3500)),
        unit(RenderMetrics(lane_bounces=3000, kv1_node_visits=30000, kv1_sphere_tests=12500))])
    assert read(ctx) == pytest.approx(16000 / 4000)
    old = types.SimpleNamespace(lane_bounces=10, sphere_hits=3)
    assert read(types.SimpleNamespace(traced_units=[unit(old)])) is None
    assert read(types.SimpleNamespace(traced_units=[unit(RenderMetrics(lane_bounces=10))])) is None
    assert read(types.SimpleNamespace(traced_units=[unit(RenderMetrics(
        lane_bounces=10, kv1_node_visits=0, kv1_sphere_tests=0))])) is None
