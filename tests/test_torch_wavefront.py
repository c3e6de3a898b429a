"""The port's wavefront traversal (rust_raytracer_torch/ops/wavefront.py)
against the JAX package's (rust_raytracer_tpu/ops/pallas_wavefront.py), its
Pallas kernels run in interpret mode, on inputs made from numpy seeds.

Bounds, and why:

- L1 keys, kernel A keys and counts (live slots), kernel L2 rows and
  totals, the fused A+L2 rows, totals and counts, the top-k slot order and
  the overflow counts: equal.  No FMA can form in the slab test
  ((a - b) * c), so XLA and torch agree bit for bit.
- MT and whole pipelines: equal hit masks, t within rtol 2e-5 / atol 1e-6
  and slot agreement >= 0.999 (tests/test_pallas.py's bounds): XLA on the
  CPU contracts the Möller–Trumbore products into FMAs, torch does not
  (ROADMAP Queue 3).  Against the port's own BVH8 walk, which runs the same
  torch arithmetic, t is equal.
- The pool render: against the port's BVH8 render, overflow 0 and equal
  images; against the JAX exact pool render, tests/test_torch_render.py's
  bounds (mean |d| / mean <= 1e-3, >= 99.5% of pixels close).

Interpret mode runs the MT kernel's slot loop unrolled, ~20 s a call at
the default 128 slots and ~3 s at 16; the whole-pipeline cases therefore
set the candidate cap to 16, which is at least the scenes' cluster count
(8 and 12), so their results are the default cap's.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rust_raytracer_tpu.ops import pallas_wavefront as pwf
from rust_raytracer_tpu.render.renderer import Renderer as JRenderer
from rust_raytracer_tpu.scene import compiler as jcompiler
from rust_raytracer_tpu.scene import graph as g
from rust_raytracer_tpu.utils import config as cfg
from rust_raytracer_torch.ops import bvh8 as tbvh8
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.ops import wavefront as twf
from rust_raytracer_torch.render import camera as tcam
from rust_raytracer_torch.render import pool as tpool
from rust_raytracer_torch.render.renderer import Renderer as TRenderer
from rust_raytracer_torch.scene import graph as tg
from rust_raytracer_torch.utils import metrics as tmetrics

from test_torch_scene import mini_dragon_scene, port_pack_from_jax, soup_scene

torch.set_num_threads(2)

N = 1021   # ragged: the port pads to whole packets, JAX to 1024 lanes
CAP = 16   # >= the soup's and mini_dragon's cluster counts (see above)


# ---------------------------------------------------------------- scenes

def _big_soup(n_tris=2048):
    rng = np.random.default_rng(23)
    centers = rng.uniform(-1, 1, (n_tris, 3))
    verts = (centers[:, None, :] + rng.normal(0, 0.06, (n_tris, 3, 3))).reshape(-1, 3)
    tris = np.arange(3 * n_tris).reshape(n_tris, 3)
    mesh = g.Mesh(vertices=verts, normals=np.zeros((0, 3)), uvs=np.zeros((0, 2)),
                  triangles=np.stack([tris, tris, np.full_like(tris, -1)], axis=-1),
                  material=g.Lambertian(g.Constant((0.5, 0.5, 0.5))))
    return g.SceneDef(world=g.Group([mesh]), lights=[])


def _one_cluster_supernodes(jp, tp):
    """Both packs with a supernode table of one cluster per supernode:
    sn_start = arange(nc), lane 0 of each bounds block the cluster box,
    +3.4e38 point boxes in the other lanes (S = nc > 1)."""
    lo, hi = np.asarray(jp.wf_cl_lo), np.asarray(jp.wf_cl_hi)
    nc = lo.shape[0]
    bounds = np.full((nc, 6, 128), 3.4e38, np.float32)
    bounds[:, 0:3, 0] = lo
    bounds[:, 3:6, 0] = hi
    tables = dict(wf_sn_lo=lo, wf_sn_hi=hi, wf_sn_start=np.arange(nc, dtype=np.int32),
                  wf_sn_bounds=bounds)
    return (dataclasses.replace(jp, **{k: jnp.asarray(v) for k, v in tables.items()}),
            tp._replace(**{k: torch.from_numpy(v) for k, v in tables.items()}))


@pytest.fixture(scope="module")
def packs():
    out = {}
    for name, scene in (("soup", soup_scene), ("mini_dragon", mini_dragon_scene),
                        ("multi", _big_soup)):
        jp, _ = jcompiler.compile_scene(scene(g) if scene is not _big_soup else scene())
        tp = port_pack_from_jax(jp)
        if name == "multi":
            jp, tp = _one_cluster_supernodes(jp, tp)
        out[name] = (jp, tp)
    assert out["soup"][0].wf_sn_lo.shape[0] == 1 and out["multi"][0].wf_sn_lo.shape[0] >= 16
    return out


def _rays(name, n=N, seed=7):
    """Seeded rays: from around the soups, or from inside the Cornell room
    (half of them aimed near the knot)."""
    rng = np.random.default_rng(seed)
    if name == "mini_dragon":
        org = rng.uniform(30, 520, (n, 3))
        aim = np.array([267.5, 200.0, 277.5]) + rng.normal(0, 60, (n, 3))
        dirn = np.where((np.arange(n) % 2 == 0)[:, None], aim - org, rng.normal(size=(n, 3)))
    else:
        org = rng.uniform(-2, 2, (n, 3))
        dirn = rng.normal(size=(n, 3))
    return org.astype(np.float32), dirn.astype(np.float32)


def _tmax(tp, org, dirn):
    """Per lane, cyclically: +inf, 3.4e38, a cap at half the exact hit (1.0
    on a miss), 0 (a dead lane)."""
    n = org.shape[0]
    t, i = tbvh8.traverse_plain(tp, torch.from_numpy(org), torch.from_numpy(dirn),
                                torch.full((n,), float("inf")))
    t, i = t.numpy(), i.numpy()
    lane = np.arange(n) % 4
    tmax = np.where(lane == 0, np.inf, 3.4e38).astype(np.float32)
    tmax[lane == 2] = np.where(i >= 0, t * 0.5, 1.0)[lane == 2]
    tmax[lane == 3] = 0.0
    return tmax


def _pad(a, n, value):
    """JAX's stage functions take whole 1024-lane groups."""
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad, constant_values=value)


def _hold(t_got, i_got, t_want, i_want):
    """Equal hit masks, t within rtol 2e-5 / atol 1e-6, slots >= 0.999."""
    hit = i_want >= 0
    np.testing.assert_array_equal(i_got >= 0, hit)
    np.testing.assert_allclose(t_got[hit], t_want[hit], rtol=2e-5, atol=1e-6)
    assert (i_got[hit] == i_want[hit]).mean() >= 0.999


# ---------------------------------------------------------------- L1 + A

@jax.jit
def _jax_l1_keys(sn_lo, sn_hi, org, dirn, t_max):
    """`_pipeline2`'s L1 keys (pallas_wavefront.py:634-658), which the
    reference writes inline."""
    n, S = org.shape[0], sn_lo.shape[0]
    inv = 1.0 / dirn
    near = jnp.full((n, S), pwf.T_MIN_STATIC, jnp.float32)
    far = jnp.broadcast_to(t_max[:, None], (n, S))
    for ax in range(3):
        t0 = (sn_lo[None, :, ax] - org[:, ax, None]) * inv[:, ax, None]
        t1 = (sn_hi[None, :, ax] - org[:, ax, None]) * inv[:, ax, None]
        near = jnp.maximum(near, jnp.minimum(t0, t1))
        far = jnp.minimum(far, jnp.maximum(t0, t1))
    tent = jnp.min(jnp.where(near <= far, near, jnp.inf).reshape(-1, pwf.R, S), axis=1)
    return jnp.where(jnp.isfinite(tent),
                     jnp.int32(0x7FFFFFFF) - lax.bitcast_convert_type(tent, jnp.int32),
                     jnp.int32(-1))


def _jax_l1(jp, org, dirn, t_max, k1):
    """(key1, sn_slot, n1, l1_cnt) as `_pipeline2` computes them (:659-664)."""
    key1 = _jax_l1_keys(jp.wf_sn_lo, jp.wf_sn_hi, org, dirn, t_max)
    S = key1.shape[1]
    if S < k1:
        key1 = jnp.pad(key1, ((0, 0), (0, k1 - S)), constant_values=-1)
    top1, sn_slot = lax.top_k(key1, k1)
    l1_cnt = jnp.sum(key1 >= 0, axis=1, dtype=jnp.int32)
    return (np.asarray(key1), np.asarray(jnp.where(top1 >= 0, sn_slot, 0)),
            np.asarray(jnp.minimum(l1_cnt, k1)), np.asarray(l1_cnt))


def _jax_cull(jp, sn_slot, n1, org, dirn, t_max, k1, kc):
    """Kernel A through pl.pallas_call in interpret mode, with the specs
    of pallas_wavefront.py:666-713."""
    n_pk = org.shape[0] // pwf.R
    rays_g = ([pwf._to_groups(org[:, i]) for i in range(3)]
              + [pwf._to_groups(dirn[:, i]) for i in range(3)])
    tmax_g = pwf._to_groups(jnp.minimum(t_max, pwf.BIG))
    G = rays_g[0].shape[0]
    S = jp.wf_sn_lo.shape[0]
    smem = pltpu.SMEM
    vmem = pltpu.VMEM
    fullc = pl.BlockSpec((G, pwf.R, 128), lambda i: (0, 0, 0), memory_space=vmem)
    tri = (lax.broadcasted_iota(jnp.int32, (pwf.SN, pwf.SN), 0)
           <= lax.broadcasted_iota(jnp.int32, (pwf.SN, pwf.SN), 1)).astype(jnp.float32)
    keys, cnt = pl.pallas_call(
        pwf._make_cull_kernel(k1, kc),
        grid=(n_pk // pwf.PPG,),
        in_specs=([pl.BlockSpec((pwf.PPG, k1), lambda i: (i, 0), memory_space=smem),
                   pl.BlockSpec((pwf.PPG, 1), lambda i: (i, 0), memory_space=smem),
                   pl.BlockSpec((S, 1), lambda i: (0, 0), memory_space=smem)]
                  + [fullc] * 7
                  + [pl.BlockSpec(jp.wf_sn_bounds.shape, lambda i: (0, 0, 0),
                                  memory_space=vmem),
                     pl.BlockSpec((pwf.SN, pwf.SN), lambda i: (0, 0), memory_space=vmem)]),
        out_specs=[pl.BlockSpec((pwf.PPG, k1, kc), lambda i: (i, 0, 0), memory_space=vmem),
                   pl.BlockSpec((pwf.PPG, k1, 1), lambda i: (i, 0, 0), memory_space=vmem)],
        out_shape=[jax.ShapeDtypeStruct((n_pk, k1, kc), jnp.int32),
                   jax.ShapeDtypeStruct((n_pk, k1, 1), jnp.int32)],
        scratch_shapes=[pltpu.VMEM((8, pwf.SN), jnp.int32), pltpu.VMEM((8, pwf.SN), jnp.int32)],
        interpret=True,
    )(jnp.asarray(sn_slot), jnp.asarray(n1)[:, None], jp.wf_sn_start[:, None], *rays_g,
      tmax_g, jp.wf_sn_bounds, tri)
    return np.asarray(keys), np.asarray(cnt)[:, :, 0]


@pytest.mark.parametrize("name,kc", [("soup", 32), ("soup", 4), ("mini_dragon", 32),
                                     ("multi", 32)])
def test_l1_and_cull_match_jax(packs, name, kc):
    jp, tp = packs[name]
    org, dirn = (_pad(a, 1024, 1.0) for a in _rays(name))
    t_max = _pad(_tmax(tp, org[:N], dirn[:N]), 1024, 0.0)
    S = jp.wf_sn_lo.shape[0]
    k1 = min(twf.K1, -(-S // 8) * 8)
    to, td, tt = (torch.from_numpy(a) for a in (org, dirn, t_max))
    key1, sn_slot, n1, l1_cnt = _jax_l1(jp, jnp.asarray(org), jnp.asarray(dirn),
                                        jnp.asarray(t_max), k1)

    # L1: keys, then the stable top k1 against lax.top_k's order
    np.testing.assert_array_equal(twf.packet_keys(tp.wf_sn_lo, tp.wf_sn_hi, to, td, tt).numpy(),
                                  key1[:, :S])
    got_slot, got_cnt = twf.nearest_boxes(tp.wf_sn_lo, tp.wf_sn_hi, to, td, tt, k1)
    np.testing.assert_array_equal(got_cnt.numpy(), l1_cnt)
    np.testing.assert_array_equal(got_slot.numpy(), sn_slot)
    assert (l1_cnt > 0).any()

    # kernel A on the same slots; JAX leaves the rows of slots >= n1 unwritten
    calls = twf.plain_calls["wf_cull"]
    keys, counts = twf.cull(got_slot, torch.clamp(got_cnt, max=k1), tp.wf_sn_start,
                            tp.wf_sn_bounds, to, td, torch.clamp(tt, max=twf.BIG), kc)
    assert twf.plain_calls["wf_cull"] == calls + 1
    want_keys, want_cnt = _jax_cull(jp, sn_slot, n1, jnp.asarray(org), jnp.asarray(dirn),
                                    jnp.asarray(t_max), k1, kc)
    live = np.arange(k1)[None, :] < n1[:, None]
    np.testing.assert_array_equal(keys.numpy()[live], want_keys[live])
    np.testing.assert_array_equal(counts.numpy()[live], want_cnt[live])
    assert (keys.numpy()[~live] == -1).all() and (counts.numpy()[~live] == 0).all()
    assert want_cnt[live].max() > (kc if kc < 32 else 0)


def _slab_hits(bounds, sn_slot, n1, org, dirn, tm, mn, mx):
    """Kernel A's slab test in numpy float32 with the given min/max:
    (hit (P, k1, SN) of live slots, near (P, k1, 8, SN))."""
    n_pk, k1 = sn_slot.shape
    with np.errstate(all="ignore"):
        inv = (np.float32(1) / dirn).reshape(n_pk, 1, pwf.R, 3, 1)
        o = org.reshape(n_pk, 1, pwf.R, 3, 1)
        blk = bounds[sn_slot][:, :, None]
        t = [(blk[..., a + 3 * e, :] - o[..., a, :]) * inv[..., a, :]
             for e in (0, 1) for a in range(3)]
        near = mx(mx(mn(t[0], t[3]), mn(t[1], t[4])), mx(mn(t[2], t[5]), np.float32(1e-3)))
        far = mn(mn(mx(t[0], t[3]), mx(t[1], t[4])),
                 mn(mx(t[2], t[5]), tm.reshape(n_pk, 1, pwf.R, 1)))
    live = np.arange(k1)[None, :] < n1[:, None]
    return (near <= far).any(axis=2) & live[..., None], near


def _old_nan_min(a, b):  # rrt::nan_min of csrc/traverse_common.cuh
    return np.where((a < b) | np.isnan(a), a, b)


def _old_nan_max(a, b):
    return np.where((a > b) | np.isnan(a), a, b)


def _edge_rows():
    """Kernel A's inputs on 128 packets over 4 synthetic supernodes (k1 =
    8): n1 = 0 and n1 = k1 rows, a supernode repeated across slots, flat
    boxes with rays on their planes whose direction has a +-0 component (a
    NaN slab), dead and capped lanes.  Returns (sn_slot, n1, sn_start,
    bounds, org, dirn, t_max, tm) as numpy arrays."""
    rng = np.random.default_rng(17)
    S, k1, n_pk, planes = 4, 8, 128, np.array([0.0, 0.5], np.float32)
    lo = np.round(rng.uniform(-1, 1, (S, 3, 128)) * 16) / 16
    hi = lo + np.round(rng.uniform(0, 0.5, (S, 3, 128)) * 16) / 16
    for sn, ax, n in ((3, 0, 64), (2, 1, 32)):        # flat in x, flat in y
        lo[sn, ax, :n] = hi[sn, ax, :n] = planes[np.arange(n) % 2]
    bounds = np.concatenate([lo, hi], axis=1).astype(np.float32)
    bounds[:, :, 120:] = 3.4e38                       # unused lanes
    org = rng.uniform(-1.5, 1.5, (n_pk * 8, 3)).astype(np.float32)
    dirn = rng.normal(size=(n_pk * 8, 3)).astype(np.float32)
    on = np.arange(32 * 8)                            # packets 0-31: on a plane
    ax = (on // 8) % 2
    org[on, ax] = planes[on % 2]
    dirn[on, ax] = np.where(on % 3 == 0, np.float32(-0.0), np.float32(0.0))
    lane = np.arange(n_pk * 8) % 4
    t_max = np.where(lane == 0, np.inf, 3.4e38).astype(np.float32)
    t_max[lane == 2] = rng.uniform(0.01, 3.0, (lane == 2).sum())
    t_max[lane == 3] = 0.0
    tm = np.minimum(t_max, np.float32(pwf.BIG))
    sn_slot = rng.integers(0, S, (n_pk, k1)).astype(np.int32)
    sn_slot[:32:2], sn_slot[1:32:2] = 3, [2, 2, 3, 3, 2, 3, 3, 2]  # repeated supernodes
    n1 = rng.integers(0, k1 + 1, n_pk).astype(np.int32)
    n1[::4], n1[1::4] = 0, k1
    return sn_slot, n1, np.arange(S, dtype=np.int32) * 128, bounds, org, dirn, t_max, tm


@pytest.mark.parametrize("kc", [4, 32])
def test_cull_edge_rows(kc):
    """Kernel A on rows the one-block-a-packet kernel treats apart: n1 = 0
    and n1 = k1, a supernode repeated across slots, and rays with a +-0
    direction component whose origin lies on a flat box's plane (a NaN
    slab: 0 * inf).  The plain version equals JAX's interpret-mode kernel
    on live rows and writes -1 / 0 on dead ones.  Premise of the kernel's
    one-instruction min.NaN / max.NaN: NaN-propagating min/max (np.minimum)
    give the hit bits of the three-instruction nan_min / nan_max; both
    differ from NaN-dropping ones (np.fmin) here, so the NaN path decides
    hits; and near is T_MIN or more (or NaN), so the sign of a zero never
    decides one."""
    sn_slot, n1, sn_start, bounds, org, dirn, t_max, tm = _edge_rows()
    S, k1 = bounds.shape[0], sn_slot.shape[1]
    keys, counts = (x.numpy() for x in twf.cull(
        *(torch.from_numpy(a) for a in (sn_slot, n1, sn_start, bounds, org, dirn, tm)), kc))
    jp = SimpleNamespace(wf_sn_lo=jnp.zeros((S, 3)), wf_sn_start=jnp.asarray(sn_start),
                         wf_sn_bounds=jnp.asarray(bounds))
    want_keys, want_cnt = _jax_cull(jp, sn_slot, n1, jnp.asarray(org), jnp.asarray(dirn),
                                    jnp.asarray(t_max), k1, kc)
    live = np.arange(k1)[None, :] < n1[:, None]
    np.testing.assert_array_equal(keys[live], want_keys[live])
    np.testing.assert_array_equal(counts[live], want_cnt[live])
    assert (keys[~live] == -1).all() and (counts[~live] == 0).all()
    assert (counts[live] > 4).any() and (counts[live] == 0).any()

    hit, near = _slab_hits(bounds, sn_slot, n1, org, dirn, tm, np.minimum, np.maximum)
    old, _ = _slab_hits(bounds, sn_slot, n1, org, dirn, tm, _old_nan_min, _old_nan_max)
    dropping, _ = _slab_hits(bounds, sn_slot, n1, org, dirn, tm, np.fmin, np.fmax)
    np.testing.assert_array_equal(hit, old)
    np.testing.assert_array_equal(hit.sum(axis=2), counts)
    assert np.isnan(near).any() and (hit != dropping).sum() > 0
    assert ((near >= np.float32(1e-3)) | np.isnan(near)).all()


def test_nearest_boxes_ties_keep_index_order():
    """Boxes that all contain the ray origins give every box the clamped
    entry t = T_MIN, one key for all: lax.top_k's order (lower index first)
    must come out."""
    rng = np.random.default_rng(3)
    lo = np.concatenate([np.full((24, 3), -5.0), rng.uniform(1, 2, (16, 3))]).astype(np.float32)
    hi = lo + np.float32(10.0)
    perm = rng.permutation(40)
    lo, hi = lo[perm], hi[perm]
    org = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    dirn = rng.normal(size=(64, 3)).astype(np.float32)
    t_max = np.full((64,), np.inf, np.float32)
    key = np.asarray(_jax_l1_keys(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(org),
                                  jnp.asarray(dirn), jnp.asarray(t_max)))
    assert (key == key.max(axis=1, keepdims=True)).sum(axis=1).min() >= 24  # ties
    top, want = lax.top_k(jnp.asarray(key), 32)
    want = jnp.where(top >= 0, want, 0)  # as _pipeline2 keeps them (:664)
    got, cnt = twf.nearest_boxes(torch.from_numpy(lo), torch.from_numpy(hi),
                                 torch.from_numpy(org), torch.from_numpy(dirn),
                                 torch.from_numpy(t_max), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cnt.numpy(), (key >= 0).sum(axis=1))


# ---------------------------------------------------------------- L2

def _compact_oracle(keys, counts, n1, k):
    n_pk, k1, kc = keys.shape
    out = np.full((n_pk, k), -1, np.int32)
    total = np.zeros(n_pk, np.int32)
    for p in range(n_pk):
        row = [keys[p, s, :min(counts[p, s], kc)] for s in range(min(n1[p], k1))]
        row = np.concatenate(row) if row else np.zeros(0, np.int32)
        total[p] = row.size
        out[p, :min(row.size, k)] = row[:k]
    return out, total


@pytest.mark.parametrize("k1", [8, 16, 24, 32, 40])
def test_compact_matches_jax_and_oracle(k1):
    """Block-prefix-dense candidates (as kernel A writes them) at row widths
    k1 * 32 = 256 ... 1280 (JAX pads 768 and 1280 to 1024 and 2048).  The
    JAX kernel's radix-4 network is held against the oracle at each width."""
    kc, k, n_pk = twf.KC, twf.PAIRS_PER_PACKET_CAP, 64
    rng = np.random.default_rng(k1)
    counts = rng.integers(0, 48, (n_pk, k1)).astype(np.int32)
    counts[rng.random((n_pk, k1)) < 0.5] = 0
    n1 = rng.integers(0, k1 + 1, n_pk).astype(np.int32)
    n1[:4] = k1
    counts[:4] = 40  # full rows: totals far above k
    keys = rng.integers(0, 1 << 14, (n_pk, k1, kc)).astype(np.int32)
    keys[np.arange(kc)[None, None, :] >= np.minimum(counts, kc)[..., None]] = -1
    want, want_total = _compact_oracle(keys, counts, n1, k)
    assert (want_total > k).any() and (want_total < k).any()

    got, total = twf.compact(torch.from_numpy(keys), torch.from_numpy(counts),
                             torch.from_numpy(n1), k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(total.numpy(), want_total)
    j_out, j_total = pwf._compact_candidates(jnp.asarray(keys), jnp.asarray(counts),
                                             jnp.asarray(n1), k, True)
    np.testing.assert_array_equal(np.asarray(j_out), want)
    np.testing.assert_array_equal(np.asarray(j_total), want_total)


# ---------------------------------------------------------------- A + L2 fused

def _caps_inside_a_slot(counts, n1, kc, k):
    """(P, k1) bool: the live slots whose kept ids the cap k cuts, off < k
    < off + min(count, kc), and (P, k1) int: each slot's offset off in the
    row."""
    live = np.arange(counts.shape[1])[None, :] < n1[:, None]
    c = np.where(live, np.minimum(counts, kc), 0)
    off = np.cumsum(c, axis=1) - c
    return (off < k) & (k < off + c), off


@pytest.mark.parametrize("name,kc,cap", [("soup", 32, 128), ("soup", 4, 128),
                                         ("mini_dragon", 32, 128), ("multi", 32, 128),
                                         ("mini_dragon", 32, 4)])
def test_cull_compact_matches_jax(packs, name, kc, cap):
    """Kernels A and L2 fused, on the L1's slots, at the pipeline's k =
    min(cap, k1 * kc), against JAX's kernel A then its L2 (both in
    interpret mode): equal rows and totals, equal counts on live slots and
    0 on dead ones.  At cap 4 the cap cuts a slot's kept ids in some
    packets."""
    jp, tp = packs[name]
    org, dirn = (_pad(a, 1024, 1.0) for a in _rays(name))
    t_max = _pad(_tmax(tp, org[:N], dirn[:N]), 1024, 0.0)
    S = jp.wf_sn_lo.shape[0]
    k1 = min(twf.K1, -(-S // 8) * 8)
    k = min(cap, k1 * kc)
    to, td, tt = (torch.from_numpy(a) for a in (org, dirn, t_max))
    sn_slot, l1_cnt = twf.nearest_boxes(tp.wf_sn_lo, tp.wf_sn_hi, to, td, tt, k1)
    n1 = torch.clamp(l1_cnt, max=k1)
    calls = twf.plain_calls["wf_cull_compact"]
    row, total, counts = (x.numpy() for x in twf.cull_compact(
        sn_slot, n1, tp.wf_sn_start, tp.wf_sn_bounds, to, td, torch.clamp(tt, max=twf.BIG),
        kc, k))
    assert twf.plain_calls["wf_cull_compact"] == calls + 1
    sn_slot, n1 = sn_slot.numpy(), n1.numpy()
    want_keys, want_cnt = _jax_cull(jp, sn_slot, n1, jnp.asarray(org), jnp.asarray(dirn),
                                    jnp.asarray(t_max), k1, kc)
    want_row, want_total = pwf._compact_candidates(jnp.asarray(want_keys), jnp.asarray(want_cnt),
                                                   jnp.asarray(n1), k, True)
    np.testing.assert_array_equal(row, np.asarray(want_row))
    np.testing.assert_array_equal(total, np.asarray(want_total))
    live = np.arange(k1)[None, :] < n1[:, None]
    np.testing.assert_array_equal(counts[live], want_cnt[live])
    assert (counts[~live] == 0).all() and (total > 0).any()
    inside, _ = _caps_inside_a_slot(counts, n1, kc, k)
    assert inside.any() == (cap == 4)


@pytest.mark.parametrize("kc,k", [(4, 16), (4, 128), (32, 16), (32, 128)])
def test_cull_compact_edge_rows(kc, k):
    """Kernels A and L2 fused on _edge_rows' inputs (n1 = 0 and n1 = k1
    rows, NaN slabs, repeated supernodes) against compact(*cull(...)), and
    against the compaction oracle and JAX's L2 (interpret mode; its row
    is at most k1 * kc wide, the port's is -1 past that) over cull's keys:
    equal rows, totals and counts.  A packet with n1 = 0 gets an all -1
    row, total 0 and zero counts.  At k = 16 the cap cuts a slot's kept
    ids after an earlier slot's (off > 0), and totals pass k."""
    sn_slot, n1, sn_start, bounds, org, dirn, t_max, tm = _edge_rows()
    args = [torch.from_numpy(a) for a in (sn_slot, n1, sn_start, bounds, org, dirn, tm)]
    row, total, counts = (x.numpy() for x in twf.cull_compact(*args, kc, k))
    keys, want_cnt = twf.cull(*args, kc)
    want_row, want_total = twf.compact(keys, want_cnt, args[1], k)
    np.testing.assert_array_equal(row, want_row.numpy())
    np.testing.assert_array_equal(total, want_total.numpy())
    np.testing.assert_array_equal(counts, want_cnt.numpy())
    keys = keys.numpy()
    o_row, o_total = _compact_oracle(keys, counts, n1, k)
    np.testing.assert_array_equal(row, o_row)
    np.testing.assert_array_equal(total, o_total)
    kj = min(k, keys.shape[1] * kc)
    j_row, j_total = pwf._compact_candidates(jnp.asarray(keys), jnp.asarray(counts),
                                             jnp.asarray(n1), kj, True)
    np.testing.assert_array_equal(row[:, :kj], np.asarray(j_row))
    assert (row[:, kj:] == -1).all()
    np.testing.assert_array_equal(total, np.asarray(j_total))

    dead, full = n1 == 0, n1 == sn_slot.shape[1]
    assert dead.any() and full.any()
    assert (row[dead] == -1).all() and (total[dead] == 0).all() and (counts[dead] == 0).all()
    inside, off = _caps_inside_a_slot(counts, n1, kc, k)
    assert (inside & (off > 0)).any() == (k == 16)
    assert (total > k).any() == (k == 16)


# ---------------------------------------------------------------- MT

@pytest.mark.parametrize("name", ["soup", "mini_dragon"])
def test_mt_matches_jax(packs, name):
    """MT on each packet's real candidate list (the port's L1 -> A -> L2),
    every list padded to CAP slots with its tail invalid."""
    jp, tp = packs[name]
    org, dirn = (_pad(a, 1024, 1.0) for a in _rays(name, seed=11))
    t_max = _pad(_tmax(tp, org[:N], dirn[:N]), 1024, 0.0)
    to, td, tt = (torch.from_numpy(a) for a in (org, dirn, t_max))
    tm = torch.clamp(tt, max=twf.BIG)
    k1 = 8
    sn_slot, l1_cnt = twf.nearest_boxes(tp.wf_sn_lo, tp.wf_sn_hi, to, td, tt, k1)
    n1 = torch.clamp(l1_cnt, max=k1)
    keys, counts = twf.cull(sn_slot, n1, tp.wf_sn_start, tp.wf_sn_bounds, to, td, tm, twf.KC)
    cl, real = twf.compact(keys, counts, n1, CAP)
    cnt = torch.clamp(real, max=CAP)
    assert cnt.max() > 1
    t, slot = twf.mt(cl, cnt, to, td, tm, tp.tri_rows)
    jt, js = pwf._mt_call(jnp.asarray(torch.clamp(cl, min=0).numpy()), jnp.asarray(cnt.numpy()),
                          jp.tri_geom, jnp.asarray(org), jnp.asarray(dirn), jnp.asarray(t_max),
                          CAP, True)
    jt, js, t, slot = np.asarray(jt), np.asarray(js), t.numpy(), slot.numpy()
    assert (slot >= 0).sum() >= 16
    _hold(t, slot, jt, js)
    np.testing.assert_array_equal(t[slot < 0], jt[js < 0])  # misses: min(t_max, 3.4e38)


def _square_clusters(spec, nc):
    """nc clusters of zero (never hit) triangles, and for each (cluster,
    lane, z) of spec the triangle v0 = (0, 0, z), e1 = (0, 2, 0), e2 =
    (2, 0, 0): a ray from (x, y, 0) along +z hits it where x, y >= 0 and
    x + y <= 2, at t = z exactly (every product and sum is exact in f32, so
    XLA's FMAs give JAX the same t).  Returns the JAX tri_geom (nc, 10,
    128) and the port's tri_rows (nc * 128, 12)."""
    geom = np.zeros((nc, 128, 10), np.float32)
    for c, lane, z in spec:
        geom[c, lane, :9] = (0, 0, z, 0, 2, 0, 2, 0, 0)
    rows = np.concatenate([geom, np.zeros((nc, 128, 2), np.float32)], axis=2)
    return jnp.asarray(np.transpose(geom, (0, 2, 1))), torch.from_numpy(rows.reshape(-1, 12))


def _mt_both(jgeom, tri_rows, rows, cnts, org, t_max):
    """MT on 128 packets (the rows and counts repeated in turn, rays along
    +z): the port's (plain on the CPU) and JAX's interpret-mode kernel,
    each as numpy (t, slot)."""
    n_pk = 128
    cl = np.zeros((n_pk, CAP), np.int32)
    cnt = np.zeros(n_pk, np.int32)
    for p in range(n_pk):
        row = rows[p % len(rows)]
        cl[p, :len(row)] = row
        cnt[p] = cnts[p % len(rows)]
    dirn = np.tile(np.array([0, 0, 1], np.float32), (n_pk * 8, 1))
    tm = np.minimum(t_max, np.float32(pwf.BIG))
    t, slot = twf.mt(*(torch.from_numpy(a) for a in (cl, cnt, org, dirn, tm)), tri_rows)
    jt, js = pwf._mt_call(jnp.asarray(cl), jnp.asarray(cnt), jgeom, jnp.asarray(org),
                          jnp.asarray(dirn), jnp.asarray(t_max), CAP, True)
    return (t.numpy(), slot.numpy()), (np.asarray(jt), np.asarray(js))


def test_mt_tie_rule_matches_jax():
    """The running best: a strict `<` per (ray, lane) in slot order, then
    the minimum t and the lowest id at that t.  Rows list a cluster twice,
    a cluster beside its identical copy (either first), clusters whose
    hits tie across lanes, cnt 0 and cnt = CAP; every t is exact, so the
    port and JAX must give the same t and the same slot everywhere."""
    C0, C1, C2, C3, C4, C5 = range(6)
    spec = [(C0, 5, 10.0), (C0, 70, 10.0), (C1, 5, 10.0), (C1, 70, 10.0),   # C1 = C0
            (C2, 3, 10.0), (C3, 100, 5.0), (C5, 5, 10.0)]                   # C4 empty
    jgeom, tri_rows = _square_clusters(spec, 6)
    # (row, cnt, t_max, the slot of a ray that hits every square, its t)
    cases = [([C1, C0], 2, np.inf, C1 * 128 + 5, 10.0),   # the copy first keeps its ids
             ([C0, C1], 2, np.inf, 5, 10.0),
             ([C5, C0], 2, np.inf, 70, 10.0),             # lane 5 keeps C5's id 645
             ([C0, C5], 2, np.inf, 5, 10.0),
             ([C0, C0], 2, np.inf, 5, 10.0),              # one cluster listed twice
             ([C2, C0], 2, np.inf, 5, 10.0),              # a tie across lanes and slots
             ([C2, C5], 2, np.inf, C2 * 128 + 3, 10.0),
             ([C3, C0, C0], 3, np.inf, C3 * 128 + 100, 5.0),
             ([C0], 0, np.inf, -1, None),                 # cnt 0
             ([C4] * (CAP - 1) + [C0], CAP, np.inf, 5, 10.0),   # cnt = CAP
             ([C4] * CAP, CAP, np.inf, -1, None),
             ([C0, C3], 2, 8.0, C3 * 128 + 100, 5.0),
             ([C0], 1, 8.0, -1, None)]                    # beyond t_max
    # per packet lane: inside, inside, on the edge x + y = 2, a vertex,
    # outside, outside, inside, on the edge x = 0
    xy = np.array([(0.5, 0.5), (0.25, 0.75), (1, 1), (0, 0), (1.5, 1.5), (-0.5, 0.5),
                   (1.25, 0.5), (0, 1.5)], np.float32)
    inside = np.array([1, 1, 1, 1, 0, 0, 1, 1], bool)
    org = np.zeros((128 * 8, 3), np.float32)
    org[:, :2] = np.tile(xy, (128, 1))
    t_max = np.array([cases[p % len(cases)][2] for p in range(128) for _ in range(8)],
                     np.float32)
    (t, slot), (jt, js) = _mt_both(jgeom, tri_rows, [c[0] for c in cases],
                                   [c[1] for c in cases], org, t_max)
    np.testing.assert_array_equal(slot, js)
    np.testing.assert_array_equal(t, jt)
    for p in range(128):
        _, _, tmax, want, want_t = cases[p % len(cases)]
        hit = inside & (want >= 0)
        np.testing.assert_array_equal(slot[8 * p:8 * p + 8], np.where(hit, want, -1))
        np.testing.assert_array_equal(t[8 * p:8 * p + 8], np.where(
            hit, np.float32(want_t or 0), np.minimum(np.float32(tmax), np.float32(pwf.BIG))))


def test_mt_dead_rays_return_tm():
    """The premise of the kernel's block-uniform skip: a ray with tm <=
    T_MIN (0, 5e-4, 1e-3) takes no hit, since no t is both > T_MIN and
    < tm, so it returns (tm, -1), beside live rays of the same packet
    (which hit a triangle at t = 0.002, just past T_MIN, and not one at
    t = 0.0008, short of it) and in packets whose rays are all dead."""
    jgeom, tri_rows = _square_clusters([(0, 5, 10.0), (1, 9, 0.002), (2, 7, 0.0008)], 3)
    lanes = {0: [0.0, 5e-4, 1e-3, np.inf, np.inf, 1.0, 0.0015, 3.4e38],  # dead beside live
             1: [0.0, 5e-4, 1e-3, 0.0, 1e-3, 5e-4, 0.0, 0.0],           # all dead
             2: [np.inf] * 8}                                           # all live
    t_max = np.array([lanes[p % 3][i] for p in range(128) for i in range(8)], np.float32)
    org = np.tile(np.array([0.5, 0.5, 0.0], np.float32), (128 * 8, 1))
    (t, slot), (jt, js) = _mt_both(jgeom, tri_rows, [[2, 1, 0]], [3], org, t_max)
    np.testing.assert_array_equal(slot, js)
    np.testing.assert_array_equal(t, jt)
    tm = np.minimum(t_max, np.float32(pwf.BIG))
    dead = tm <= np.float32(pwf.T_MIN_STATIC)
    by_packet = dead.reshape(128, 8)
    assert by_packet.all(axis=1).sum() == 43 and by_packet.any(axis=1).sum() == 86
    assert (slot[dead] == -1).all() and (t[dead] == tm[dead]).all()
    hit = ~dead & (tm > np.float32(0.002))
    assert (slot[hit] == 128 + 9).all() and (t[hit] == np.float32(0.002)).all()
    assert (slot[~dead & ~hit] == -1).all() and (t[~dead & ~hit] == tm[~dead & ~hit]).all()


# ---------------------------------------------------------------- pipelines

def _both_pipelines(jp, tp, org, dirn, t_max, **caps):
    got = twf.intersect_triangles_wavefront(
        tp, torch.from_numpy(org), torch.from_numpy(dirn), None, torch.from_numpy(t_max),
        return_overflow=True, **caps)
    want = pwf.intersect_triangles_wavefront(
        jp, jnp.asarray(org), jnp.asarray(dirn), None, jnp.asarray(t_max),
        interpret=True, return_overflow=True)
    got = tuple(x.numpy() for x in got)
    want = tuple(np.asarray(x) for x in want)
    assert got[2].dtype == np.int64 and got[2].shape == ()
    return got, want


@pytest.fixture
def jax_caps(monkeypatch, request):
    """Set the JAX pipeline's module caps (read at trace time), with its
    trace caches cleared now and on teardown."""
    def set_caps(**caps):
        for name, value in caps.items():
            monkeypatch.setattr(pwf, name, value)
        pwf._pipeline2.clear_cache()
        pwf._pipeline.clear_cache()
    request.addfinalizer(pwf._pipeline2.clear_cache)
    request.addfinalizer(pwf._pipeline.clear_cache)
    return set_caps


@pytest.mark.parametrize("name", ["soup", "mini_dragon"])
def test_pipeline_matches_jax(packs, jax_caps, name):
    """The whole two-level pipeline, N = 1021 rays with t_max +inf,
    3.4e38, capped below the hit and 0 by lane: the same hits and overflow
    count as JAX; against the port's BVH8 walk, equal t."""
    jp, tp = packs[name]
    jax_caps(PAIRS_PER_PACKET_CAP=CAP)
    assert jp.wf_cl_lo.shape[0] <= CAP
    org, dirn = _rays(name)
    t_max = _tmax(tp, org, dirn)
    (t, slot, ov), (jt, js, jov) = _both_pipelines(jp, tp, org, dirn, t_max, cap=CAP)
    assert int(ov) == int(jov) == 0
    assert (slot >= 0).sum() >= 16
    _hold(t, slot, jt, js)
    np.testing.assert_array_equal(t[slot < 0], t_max[slot < 0])  # t == t_max on a miss
    assert (slot[3::4] < 0).all() and (slot[2::4] < 0).all()     # dead and capped lanes
    bt, bs = tbvh8.traverse_plain(tp, *(torch.from_numpy(a) for a in (org, dirn, t_max)))
    np.testing.assert_array_equal(slot >= 0, bs.numpy() >= 0)
    np.testing.assert_array_equal(t, bt.numpy())
    assert (slot == bs.numpy()).mean() >= 0.999


# each cause of overflow, alone: scene, JAX module caps, the port's keywords
_CAUSES = {
    # l1_cnt > k1: more than 8 of the one-cluster supernodes hit
    "supernodes": ("multi", dict(K1=8, PAIRS_PER_PACKET_CAP=CAP), dict(k1=8, cap=CAP)),
    # a block count > KC: more than 4 of the soup's 8 clusters in its supernode
    "block": ("soup", dict(KC=4, PAIRS_PER_PACKET_CAP=CAP), dict(kc=4, cap=CAP)),
    # real > k: more than 4 candidates in all
    "pairs": ("soup", dict(PAIRS_PER_PACKET_CAP=4), dict(cap=4)),
}


@pytest.mark.parametrize("cause", sorted(_CAUSES))
def test_overflow_matches_jax(packs, jax_caps, cause):
    """Small caps make one overflow cause happen: the same count as JAX,
    and the same candidate lists, so the same hits on every packet."""
    name, jcaps, caps = _CAUSES[cause]
    jp, tp = packs[name]
    jax_caps(**jcaps)
    org, dirn = _rays(name, seed=5)
    t_max = np.full(org.shape[0], np.inf, np.float32)
    (t, slot, ov), (jt, js, jov) = _both_pipelines(jp, tp, org, dirn, t_max, **caps)
    assert int(ov) == int(jov) > 0

    # which cause fired, from the port's stages on the same rays
    o, d, tm = (torch.from_numpy(_pad(a, 1024, v)) for a, v in
                ((org, 1.0), (dirn, 1.0), (t_max, 0.0)))
    S = tp.wf_sn_lo.shape[0]
    k1 = min(caps.get("k1", twf.K1), -(-S // 8) * 8)
    kc = caps.get("kc", twf.KC)
    k = min(caps.get("cap", twf.PAIRS_PER_PACKET_CAP), k1 * kc)
    sn_slot, l1_cnt = twf.nearest_boxes(tp.wf_sn_lo, tp.wf_sn_hi, o, d, tm, k1)
    n1 = torch.clamp(l1_cnt, max=k1)
    _, real, counts = twf.cull_compact(sn_slot, n1, tp.wf_sn_start, tp.wf_sn_bounds, o, d,
                                       torch.clamp(tm, max=twf.BIG), kc, k)
    live = torch.arange(k1)[None, :] < n1[:, None]
    fired = {"supernodes": int((l1_cnt > k1).sum()),
             "block": int(((counts > kc) & live).any(dim=1).sum()),
             "pairs": int((real > k).sum())}
    assert fired[cause] > 0, fired
    assert all(v == 0 for c, v in fired.items() if c != cause), fired

    _hold(t, slot, jt, js)
    bt, bs = tbvh8.traverse_plain(tp, *(torch.from_numpy(a) for a in (org, dirn, t_max)))
    bt, bs = bt.numpy(), bs.numpy()
    # a dropped candidate can lose a hit, never report a nearer one
    assert not ((slot >= 0) & (bs < 0)).any()
    both = (slot >= 0) & (bs >= 0)
    assert (t[both] >= bt[both]).all()


@pytest.mark.parametrize("cap", [2, twf.PAIRS_PER_PACKET_CAP])
def test_dense_pipeline_matches_jax(packs, jax_caps, cap):
    """The dense single-level pipeline (reached when nc >= 2^14 or without
    supernode tables): cap 2 overflows on the soup's 8 clusters, the
    default cap keeps them all."""
    jp, tp = packs["soup"]
    jax_caps(PAIRS_PER_PACKET_CAP=cap)
    org, dirn = _rays("soup", n=1024, seed=7)
    t_max = np.full(1024, np.inf, np.float32)
    tm = np.minimum(t_max, np.float32(pwf.BIG))
    t, slot, dropped = twf.pipeline(tp.wf_cl_lo, tp.wf_cl_hi, tp.tri_rows,
                                    torch.from_numpy(org), torch.from_numpy(dirn),
                                    torch.from_numpy(t_max), cap=cap)
    jt, js, _, jov = pwf._pipeline(jp.wf_cl_lo, jp.wf_cl_hi, jp.tri_geom, jnp.asarray(org),
                                   jnp.asarray(dirn), jnp.asarray(tm), interpret=True)
    assert int(dropped.sum()) == int(jov)
    assert (int(jov) > 0) == (cap == 2)
    _hold(t.numpy(), slot.numpy(), np.asarray(jt), np.asarray(js))


# ---------------------------------------------------------------- wrappers

def test_wrappers_check_inputs(packs):
    _, tp = packs["soup"]
    org, dirn = (torch.from_numpy(a[:64]) for a in _rays("soup"))
    tm = torch.full((64,), twf.BIG)
    sn_slot = torch.zeros((8, 8), dtype=torch.int32)
    n1 = torch.ones(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="kc"):
        twf.cull(sn_slot, n1, tp.wf_sn_start, tp.wf_sn_bounds, org, dirn, tm, 129)
    with pytest.raises(TypeError):
        twf.cull(sn_slot.long(), n1, tp.wf_sn_start, tp.wf_sn_bounds, org, dirn, tm, 32)
    with pytest.raises(TypeError):
        twf.mt(sn_slot, n1, org.double(), dirn, tm, tp.tri_rows)
    with pytest.raises(ValueError, match="kc"):
        twf.cull_compact(sn_slot, n1, tp.wf_sn_start, tp.wf_sn_bounds, org, dirn, tm, 0, 16)
    with pytest.raises(ValueError, match="k must"):
        twf.cull_compact(sn_slot, n1, tp.wf_sn_start, tp.wf_sn_bounds, org, dirn, tm, 32, 0)
    with pytest.raises(TypeError):
        twf.cull_compact(sn_slot, n1.long(), tp.wf_sn_start, tp.wf_sn_bounds, org, dirn, tm,
                         32, 16)
    before = dict(twf.launches)
    twf.cull_compact(sn_slot, n1, tp.wf_sn_start, tp.wf_sn_bounds, org, dirn, tm, 32, 16)
    twf.mt(sn_slot, n1, org, dirn, tm, tp.tri_rows)
    assert twf.launches == before  # a CPU tensor never counts a launch
    # no wavefront tables: an explicit "wavefront" raises, as in JAX
    bare = tp._replace(wf_cl_lo=tp.wf_cl_lo[:0])
    with pytest.raises(ValueError, match="wavefront"):
        tisect.intersect_triangles(bare, org, dirn, None, tm, kernel="wavefront")
    t, slot, ov = twf.intersect_triangles_wavefront(bare, org, dirn, None, tm,
                                                    return_overflow=True)
    assert (slot == -1).all() and torch.equal(t, tm) and int(ov) == 0


# ---------------------------------------------------------------- the slice

def test_pool_render_wavefront_matches_bvh8_and_jax():
    """mini_dragon 32x32, 4 spp, depth 8 through the pool with
    kernel="wavefront" on the CPU: each step runs the fused cull+compact
    and MT once and neither standalone stage, no overflow (12 clusters in one
    supernode), the port's BVH8 render's image, and the JAX exact render's
    within test_torch_render.py's bounds."""
    scene = mini_dragon_scene(tg)
    sc = cfg.merge_scene_config(scene.config, {"output_width": 32})
    rc = cfg.RenderConfig(samples_per_pixel=4, max_depth=8)
    cam = tcam.camera_from_config(sc, rc)
    lanes = 1024
    calls = dict(twf.plain_calls)
    metrics = tmetrics.RenderMetrics()
    got = TRenderer(scene, cam, batch_size=lanes, kernel="wavefront",
                    device="cpu").render(mode="pool", metrics=metrics).hdr()
    called = {k: twf.plain_calls[k] - calls[k] for k in twf.KERNELS}
    assert metrics.steps > 0 and called == {"wf_cull_compact": metrics.steps, "wf_cull": 0,
                                            "wf_compact": 0, "wf_mt": metrics.steps}, called
    assert (metrics.wf_overflow_packets == 0
            and metrics.wf_total_packets == (lanes // 8) * metrics.steps)
    exact = TRenderer(scene, cam, batch_size=lanes, kernel="auto", device="cpu")
    np.testing.assert_array_equal(got, exact.render(mode="pool").hdr())
    want = JRenderer(mini_dragon_scene(g), cfg.make_camera(sc, rc), batch_size=lanes,
                     kernel="jnp").render(mode="pool").hdr()
    rel = np.abs(got - want).mean() / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    assert rel <= 1e-3, rel
    assert close >= 0.995, close
