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

The CUDA kernel walks per ray without the oracle's T_MIN clamp on the
slab's near distance; `_unclamped_walk` repeats its control flow in numpy
and shows that the extra leaves it enters change no result.
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


def _unclamped_walk(tp, org, dirn, t_max):
    """The CUDA kernel's control flow (csrc/threaded_traverse.cu), one ray
    at a time in numpy: no T_MIN clamp on near, best t starting at
    min(t_max, 3.4e38), a lane with best <= T_MIN skipping the walk, the
    node table read from `bvh_node_rows`.  Leaves go through the same
    Möller–Trumbore (`mt_rows`).  Returns (t, slot, leaves entered)."""
    rows = tp.bvh_node_rows.numpy()
    links = rows.view(np.int32)
    tri = tp.tri_rows.view(-1, tthr.CLUSTER, 12)
    n_nodes = rows.shape[0]
    t_out = t_max.copy()
    slot = np.full(org.shape[0], -1, np.int32)
    leaves = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(org.shape[0]):
            o, inv = org[i], np.float32(1.0) / dirn[i]
            best = np.minimum(t_max[i], np.float32(3.4e38))
            node = 0 if best > np.float32(tthr.T_MIN_STATIC) else n_nodes
            while node < n_nodes:
                t0 = (rows[node, 0:3] - o) * inv
                t1 = (rows[node, 3:6] - o) * inv
                near = np.max(np.minimum(t0, t1))
                far = min(np.min(np.maximum(t0, t1)), best)
                link = links[node, 7]
                if near <= far and link < 0:
                    leaves += 1
                    tt = tthr.mt_rows(torch.from_numpy(o[None]), torch.from_numpy(dirn[i][None]),
                                      tri[-link - 1][None], torch.tensor([best]))[0].numpy()
                    k = int(np.argmin(tt))
                    if tt[k] < best:
                        best, slot[i] = tt[k], (-link - 1) * tthr.CLUSTER + k
                    node = links[node, 6]
                else:
                    node = link if near <= far else links[node, 6]
            if slot[i] >= 0:
                t_out[i] = best
    return t_out, slot, leaves


@pytest.mark.parametrize("name", ["soup", "mini_dragon"])
def test_unclamped_walk_equals_plain(packs, name):
    """The kernel's walk enters boxes that lie behind T_MIN, which the
    plain version's clamped near skips; those leaves hold no acceptable
    hit, so (t, slot) are equal bit for bit, ties included."""
    _, tp = packs[name]
    org, dirn = _rays(name, seed=9)
    t_max = _t_max_mix(tp, org, dirn)
    counts = {}
    want = tthr.traverse_plain(tp, *(torch.from_numpy(a) for a in (org, dirn, t_max)), counts)
    t, slot, leaves = _unclamped_walk(tp, org, dirn, t_max)
    assert leaves > counts["leaf_visits"]  # the extra leaves exist in this data
    np.testing.assert_array_equal(slot, want[1].numpy())
    np.testing.assert_array_equal(t, want[0].numpy())


def test_plain_counts(packs):
    """The plain walk's counts: every visit is a slab test, leaf visits are
    a part of them, and distinct nodes and clusters are bounded by the
    tables."""
    _, tp = packs["mini_dragon"]
    org, dirn = _rays("mini_dragon")
    counts = {}
    tthr.traverse_plain(tp, torch.from_numpy(org), torch.from_numpy(dirn),
                        torch.full((N,), float("inf")), counts)
    assert set(counts) == {"node_visits", "leaf_visits", "nodes", "clusters"}
    assert 0 < counts["leaf_visits"] < counts["node_visits"]
    assert 0 < counts["clusters"] <= tp.tri_rows.shape[0] // tthr.CLUSTER
    assert counts["clusters"] < counts["nodes"] <= tp.bvh_min.shape[0]


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
