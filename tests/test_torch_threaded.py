"""The threaded-BVH traversal (K3, rust_raytracer_torch/ops/threaded.py)
against the JAX package.

K3's plain version (the CUDA kernel's CPU counterpart, reached through the
wrapper) is held against the JAX K3 Pallas kernel in interpret mode and
against the JAX threaded walk (kernel="jnp") on the tests/test_pallas.py
soup and the mini cornell_dragon, with a ragged ray count and t_max of
+inf, 3.4e38, a cap short of the hit, and 0: hit masks equal, t within rtol
2e-5 / atol 1e-6 (XLA contracts a*b+c into FMAs, torch does not), slot
agreement >= 0.999 against the interpret kernel (its 128-ray packets test
every cluster a packet-mate hits, so an equal-t tie may break differently)
and equal slots against the jnp walk, whose visit order is the plain
version's.

The reference's Pallas kernel does not clamp the slab's near distance at
T_MIN, the oracle and the CUDA kernels do; `_walk` repeats the per-ray
walk in numpy either way and shows that the extra leaves the unclamped walk
enters change no result, and that the clamped walk (the CUDA kernel's)
makes the plain version's visits.  The CUDA kernels test a leaf with the
whole warp (csrc/traverse_common.cuh:warp_leaf_test); `_warp_leaf_test`
repeats that in torch ops and is held against the sequential scan.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytracer_tpu.ops import intersect as jisect
from rust_raytracer_tpu.ops import pallas_intersect as ppi
from rust_raytracer_tpu.scene import compiler as jcompiler
from rust_raytracer_torch.ops import bvh8 as tbvh8
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.ops import threaded as tthr

from test_torch_scene import jax_graph, mini_dragon_scene, port_pack_from_jax, soup_scene

torch.set_num_threads(2)

N = 300  # ragged: not a multiple of the reference kernel's 128-ray packet


@pytest.fixture(scope="module")
def packs():
    out = {}
    for name, scene in (("soup", soup_scene), ("mini_dragon", mini_dragon_scene)):
        jp, _ = jcompiler.compile_scene(scene(jax_graph()))
        out[name] = (jp, port_pack_from_jax(jp))
    return out


def _rays(name, n=N, seed=3):
    """Seeded rays: from around the soup, or from inside the Cornell room
    (half of them aimed near the knot)."""
    rng = np.random.default_rng(seed)
    if name == "soup":
        org = rng.uniform(-2, 2, (n, 3))
        dirn = rng.normal(size=(n, 3))
    else:
        org = rng.uniform([50, 50, 50], [500, 500, 500], (n, 3))
        dirn = rng.normal(size=(n, 3))
        aim = rng.uniform([180, 120, 200], [360, 280, 360], (n // 2, 3))
        dirn[: n // 2] = aim - org[: n // 2]
    return org.astype(np.float32), dirn.astype(np.float32)


def _t_max_mix(tp, org, dirn):
    """Per lane: +inf, 0 (dead), 3.4e38, or half the distance to the hit
    (+inf where the ray hits nothing)."""
    t, slot = tthr.traverse_plain(tp, *(torch.from_numpy(a) for a in (org, dirn)),
                                  torch.full((org.shape[0],), float("inf")))
    t, slot = t.numpy(), slot.numpy()
    lane = np.arange(org.shape[0])
    cap = np.where(slot >= 0, t * 0.5, np.inf)
    return np.select([lane % 4 == 0, lane % 4 == 1, lane % 4 == 2],
                     [np.inf, 0.0, 3.4e38], cap).astype(np.float32)


def _port(tp, org, dirn, t_max):
    calls = tthr.plain_calls
    got = tthr.intersect_triangles_threaded(tp, *(torch.from_numpy(a) for a in (org, dirn)),
                                            None, torch.from_numpy(t_max))
    assert tthr.plain_calls == calls + 1
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    return tuple(x.numpy() for x in got)


def _hold(got, want, min_agree):
    (t_got, i_got), (t_want, i_want) = got, want
    hit_got, hit_want = i_got >= 0, i_want >= 0
    np.testing.assert_array_equal(hit_got, hit_want)
    np.testing.assert_allclose(t_got[hit_got], t_want[hit_want], rtol=2e-5, atol=1e-6)
    agree = (i_got[hit_got] == i_want[hit_want]).mean()
    assert agree >= min_agree, agree


@pytest.mark.parametrize("name", ["soup", "mini_dragon"])
def test_threaded_plain_matches_jax(packs, name):
    jp, tp = packs[name]
    org, dirn = _rays(name)
    t_max = _t_max_mix(tp, org, dirn)
    got = _port(tp, org, dirn, t_max)
    ja = [jnp.asarray(org), jnp.asarray(dirn), jnp.full((N,), 1e-3, jnp.float32),
          jnp.asarray(t_max)]
    k3 = ppi.intersect_triangles_pallas(jp, *ja, interpret=True)
    walk = jisect.intersect_triangles(jp, *ja, kernel="jnp")
    k3, walk = (tuple(np.asarray(x) for x in r) for r in (k3, walk))
    lane = np.arange(N)
    assert (got[1] >= 0).sum() >= 16
    assert not (got[1][lane % 4 == 1] >= 0).any() and not (got[1][lane % 4 == 3] >= 0).any()
    _hold(got, k3, 0.999)
    _hold(got, walk, 1.0)
    miss = got[1] < 0
    np.testing.assert_array_equal(got[0][miss], t_max[miss])  # t == t_max on a miss
    np.testing.assert_array_equal(k3[0][miss], t_max[miss])


INF = float("inf")


def _scan(o, d, clusters, best):
    """Möller–Trumbore (`mt_rows`) and the sequential scan: slots in order,
    a strict `<` against the running best.  `clusters` is a list of
    (cluster id, rows (L, 128, 12)) tested in turn.  Returns (best, slot)."""
    best, slot = best.clone(), torch.full(best.shape, -1, dtype=torch.int64)
    for c, rows in clusters:
        tt = tthr.mt_rows(o, d, rows, best)
        for i in range(tt.shape[0]):
            for k in range(tthr.CLUSTER):
                if tt[i, k] < best[i]:
                    best[i], slot[i] = tt[i, k], c * tthr.CLUSTER + k
    return best, slot


def _warp_leaf_test(o, d, rows, best):
    """csrc/traverse_common.cuh:warp_leaf_test in torch ops, for L pending
    lanes each with its own cluster rows (L, 128, 12): lane k of the warp
    tests slots k, k + 32, k + 64, k + 96 and keeps its lowest-slot best; a
    butterfly of 5 steps takes the lexicographic minimum of (t, slot); the
    owner accepts it only if strictly below its best.  Returns (accepted,
    t, slot within the cluster)."""
    tt = tthr.mt_rows(o, d, rows, best)
    n = tt.shape[0]
    lane = torch.arange(32)
    t = torch.full((n, 32), INF)
    slot = torch.full((n, 32), tthr.CLUSTER, dtype=torch.int64)
    for j in range(tthr.CLUSTER // 32):
        k = (lane + 32 * j).expand(n, 32)
        tk = tt[:, lane + 32 * j]
        take = tk < t
        t, slot = torch.where(take, tk, t), torch.where(take, k, slot)
    for m in (16, 8, 4, 2, 1):
        ot, os_ = t[:, lane ^ m], slot[:, lane ^ m]
        take = (ot < t) | ((ot == t) & (os_ < slot))
        t, slot = torch.where(take, ot, t), torch.where(take, os_, slot)
    assert torch.equal(t, t[:, :1].expand(n, 32)) and torch.equal(slot, slot[:, :1].expand(n, 32))
    return t[:, 0] < best, t[:, 0], slot[:, 0]


def _leaf_rows(rng, z):
    """(n, 128, 12) rows: in slot k of row i a triangle in the plane z =
    z[i, k] (hit_back set) that every ray of `_leaf_rays` crosses; a NaN z
    leaves the slot empty (all zeros: det 0, rejected)."""
    rows = np.zeros(z.shape + (12,), np.float32)
    full = ~np.isnan(z)
    rows[..., 0] = np.where(full, rng.uniform(-4, -3, z.shape), 0)
    rows[..., 1] = np.where(full, rng.uniform(-4, -3, z.shape), 0)
    rows[..., 2] = np.where(full, z, 0)
    rows[..., 3] = rows[..., 7] = np.where(full, 20.0, 0)  # e1 = (20, 0, 0), e2 = (0, 20, 0)
    rows[..., 9] = np.where(full, 1.0, 0)
    return torch.from_numpy(rows)


def _leaf_rays(rng, n):
    org = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n), np.zeros(n)], -1)
    dirn = np.stack([rng.normal(0, 0.02, n), rng.normal(0, 0.02, n), np.ones(n)], -1)
    return torch.from_numpy(org.astype(np.float32)), torch.from_numpy(dirn.astype(np.float32))


# (cluster, slot) pairs given the same nearest triangle; clusters are
# visited 0 then 1, slot 9 sits in lane 9 and slot 70 in lane 6
_TIES = {"tie_in_one_lane": ((0, 5), (0, 37)), "tie_in_two_lanes": ((0, 9), (0, 70)),
         "tie_across_clusters": ((0, 100), (1, 3)), "t_equals_best": ((0, 50), (0, 50))}


@pytest.mark.parametrize("case", ["random", *_TIES, "all_miss", "t_max_0", "t_max_inf",
                                  "t_max_3.4e38"])
def test_warp_leaf_test_equals_scan(case):
    """The warp-cooperative leaf test, applied to two clusters in turn as a
    ray's walk does, equals Möller–Trumbore plus the sequential scan: the
    same t bit for bit and the same slot, ties included (the lowest slot of
    a cluster, the earlier cluster), and a t equal to the best is refused."""
    rng = np.random.default_rng(17)
    n = 64
    z = rng.uniform(1, 50, (2, n, tthr.CLUSTER))
    z[rng.uniform(size=z.shape) < 0.5] = np.nan
    if case == "all_miss":
        z[:] = np.nan
    if case in _TIES:
        (ca, ka), _ = _TIES[case]
        z[ca, :, ka] = 0.5  # nearer than every other slot
    rows = [_leaf_rows(rng, zc) for zc in z]
    if case in _TIES:
        (ca, ka), (cb, kb) = _TIES[case]
        rows[cb][:, kb] = rows[ca][:, ka]  # the same triangle: the same t bit for bit
    o, d = _leaf_rays(rng, n)
    t_max = {"t_max_0": 0.0, "t_max_inf": INF}.get(case, 3.4e38)
    best0 = torch.clamp(torch.full((n,), t_max), max=3.4e38)  # the kernels' clamp of +inf
    if case == "t_equals_best":
        best0 = _scan(o, d, [(0, rows[0])], best0)[0]  # the nearest t exactly
    ids = (4, 2)  # cluster ids, visited 4 then 2
    want_t, want_slot = _scan(o, d, list(zip(ids, rows)), best0)
    best, slot = best0.clone(), torch.full((n,), -1, dtype=torch.int64)
    for c, r in zip(ids, rows):
        acc, t, k = _warp_leaf_test(o, d, r, best)
        best, slot = torch.where(acc, t, best), torch.where(acc, c * tthr.CLUSTER + k, slot)
    assert torch.equal(best, want_t) and torch.equal(slot, want_slot)
    if case in ("all_miss", "t_max_0", "t_equals_best"):
        assert not (slot >= 0).any()
    else:
        assert (slot >= 0).all()
    if case in _TIES and case != "t_equals_best":
        (ca, ka), _ = _TIES[case]
        assert (slot == ids[ca] * tthr.CLUSTER + ka).all()


def _walk(tp, org, dirn, t_max, clamp):
    """The per-ray walk of the threaded BVH in numpy, one ray at a time:
    best t starting at min(t_max, 3.4e38), the node table read from
    `bvh_node_rows`, the slab's near clamped at T_MIN when `clamp` (the CUDA
    kernel, csrc/threaded_traverse.cu) or not (the slab test of the
    reference's Pallas kernel), each leaf through `_warp_leaf_test`.
    Returns (t, slot, counts) with counts for warps of 32 lanes in ray
    order as `traverse_plain` gives them."""
    rows = tp.bvh_node_rows.numpy()
    links = rows.view(np.int32)
    tri = tp.tri_rows.view(-1, tthr.CLUSTER, 12)
    n_nodes = rows.shape[0]
    t_out = t_max.copy()
    slot = np.full(org.shape[0], -1, np.int32)
    visits = leaves = 0
    warp_steps, leaf_steps = {}, set()
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(org.shape[0]):
            o, inv = org[i], np.float32(1.0) / dirn[i]
            best = np.minimum(t_max[i], np.float32(3.4e38))
            node, step = 0, 0
            while node < n_nodes:
                t0 = (rows[node, 0:3] - o) * inv
                t1 = (rows[node, 3:6] - o) * inv
                near = np.max(np.minimum(t0, t1))
                if clamp:
                    near = max(near, np.float32(tthr.T_MIN_STATIC))
                far = min(np.min(np.maximum(t0, t1)), best)
                link = links[node, 7]
                if near <= far and link < 0:
                    leaves += 1
                    leaf_steps.add((i // 32, step))
                    acc, t, k = _warp_leaf_test(
                        torch.from_numpy(o[None]), torch.from_numpy(dirn[i][None]),
                        tri[-link - 1][None], torch.tensor([best], dtype=torch.float32))
                    if acc[0]:
                        best = np.float32(t[0].item())
                        slot[i] = (-link - 1) * tthr.CLUSTER + int(k[0])
                    node = links[node, 6]
                else:
                    node = link if near <= far else links[node, 6]
                visits += 1
                step += 1
            warp_steps[i // 32] = max(warp_steps.get(i // 32, 0), step)
            if slot[i] >= 0:
                t_out[i] = best
    return t_out, slot, dict(node_visits=visits, leaf_visits=leaves,
                             warp_steps=sum(warp_steps.values()),
                             warp_leaf_passes=len(leaf_steps))


@pytest.mark.parametrize("name", ["soup", "mini_dragon"])
def test_unclamped_walk_equals_plain(packs, name):
    """The reference kernel's walk enters boxes that lie behind T_MIN,
    which the plain version's clamped near skips; those leaves hold no
    acceptable hit, so (t, slot) are equal bit for bit, ties included."""
    _, tp = packs[name]
    org, dirn = _rays(name, seed=9)
    t_max = _t_max_mix(tp, org, dirn)
    counts = {}
    want = tthr.traverse_plain(tp, *(torch.from_numpy(a) for a in (org, dirn, t_max)), counts)
    t, slot, walked = _walk(tp, org, dirn, t_max, clamp=False)
    assert walked["leaf_visits"] > counts["leaf_visits"]  # the extra leaves exist in this data
    np.testing.assert_array_equal(slot, want[1].numpy())
    np.testing.assert_array_equal(t, want[0].numpy())


@pytest.mark.parametrize("name", ["soup", "mini_dragon"])
def test_clamped_walk_equals_plain(packs, name):
    """The CUDA kernel's walk (near clamped at T_MIN, the warp-cooperative
    leaf test) gives the plain version's (t, slot) and makes its visits:
    node and leaf visits, warp loop iterations and warp leaf passes equal
    the counts `traverse_plain` reports, dead lanes included."""
    _, tp = packs[name]
    org, dirn = _rays(name, seed=9)
    t_max = _t_max_mix(tp, org, dirn)
    counts = {}
    want = tthr.traverse_plain(tp, *(torch.from_numpy(a) for a in (org, dirn, t_max)), counts)
    t, slot, walked = _walk(tp, org, dirn, t_max, clamp=True)
    np.testing.assert_array_equal(slot, want[1].numpy())
    np.testing.assert_array_equal(t, want[0].numpy())
    assert walked == {k: counts[k] for k in walked}
    # the idle lanes of a per-thread leaf loop exist in this data
    assert walked["leaf_visits"] < 32 * walked["warp_leaf_passes"]


def test_plain_counts(packs):
    """The plain walk's counts: every visit is a slab test, leaf visits are
    a part of them, distinct nodes and clusters are bounded by the tables,
    and a warp runs a leaf pass in some of its loop iterations, each
    holding 1 to 32 leaf visits."""
    _, tp = packs["mini_dragon"]
    org, dirn = _rays("mini_dragon")
    counts = {}
    tthr.traverse_plain(tp, torch.from_numpy(org), torch.from_numpy(dirn),
                        torch.full((N,), float("inf")), counts)
    assert set(counts) == {"node_visits", "leaf_visits", "nodes", "clusters", "warp_steps",
                           "warp_leaf_passes"}
    assert 0 < counts["leaf_visits"] < counts["node_visits"]
    assert 0 < counts["clusters"] <= tp.tri_rows.shape[0] // tthr.CLUSTER
    assert counts["clusters"] < counts["nodes"] <= tp.bvh_min.shape[0]
    assert 0 < counts["warp_leaf_passes"] < counts["warp_steps"] <= counts["node_visits"]
    assert counts["warp_leaf_passes"] <= counts["leaf_visits"] <= 32 * counts["warp_leaf_passes"]


def test_threaded_wrapper_rejects_bad_inputs(packs):
    _, tp = packs["soup"]
    org = torch.zeros((8, 3))
    with pytest.raises(TypeError):
        tthr.intersect_triangles_threaded(tp, org.double(), org, None, torch.zeros(8))
    with pytest.raises(ValueError):
        tthr.intersect_triangles_threaded(tp, org, org, None, torch.zeros(7))
    with pytest.raises(ValueError):
        tthr.intersect_triangles_threaded(tp, org, org[:, :2], None, torch.zeros(8))
    with pytest.raises(ValueError, match="meta"):
        tthr.intersect_triangles_threaded(tp, org, org, None, torch.zeros(8, device="meta"))
    meta = org.to("meta")
    with pytest.raises(ValueError, match="no threaded traversal"):
        tthr.intersect_triangles_threaded(tp, meta, meta, None, torch.zeros(8, device="meta"))


@pytest.mark.parametrize("kernel,depth,walk", [
    ("auto", None, "bvh8"),       # the BVH8 kernel's stack holds the scene
    ("auto", 40, "threaded"),     # 8 * 40 + 1 > STACK: the threaded walk
    ("threaded", None, "threaded"),
    ("bvh8", None, "bvh8"),
])
def test_auto_dispatch(packs, kernel, depth, walk):
    """kernel="auto" takes K3 exactly where the BVH8 kernel cannot run the
    scene (a BVH8 depth whose stack passes STACK), decided from the pack;
    the plain_calls counters show which walk ran."""
    assert tisect.check_kernel(kernel) is None
    _, tp = packs["soup"]
    if depth is not None:
        tp = tp._replace(bvh8_depth=depth)
        assert 8 * depth + 1 > tbvh8.STACK and not tbvh8.fits(tp)
    org, dirn = (torch.from_numpy(a) for a in _rays("soup", n=64))
    before = tthr.plain_calls, tbvh8.plain_calls
    t, slot = tisect.intersect_triangles(tp, org, dirn, 1e-3, torch.full((64,), float("inf")),
                                         kernel=kernel)
    ran = {"threaded": tthr.plain_calls - before[0], "bvh8": tbvh8.plain_calls - before[1]}
    assert ran == {w: int(w == walk) for w in ran}
    want = tthr.traverse_plain(tp, org, dirn, torch.full((64,), float("inf")))
    assert torch.equal(slot, want[1]) and torch.equal(t, want[0])
