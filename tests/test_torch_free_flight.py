"""The free-flight kernel KV-FF (csrc/free_flight.cu, ops/vertex.py:
free_flight) on the CPU: its place in the path vertex, its route, its
argument checks and the table rows it reads.

The kernel runs only on the card, where scripts/free_flight_check.py holds
it against ops/intersect.py:merge_volumes bit for bit.  Here:

- `fused_vertex` launches it once, between KV1 (and the walk) and KV2, in
  a scene with volumes, and hands its (t, kind, prim) to KV2 as the
  merged hit; in a scene without volumes it launches nothing new
  (`vertex._launch` is replaced by a recorder, so nothing runs);
- the route: on the card with a float32 pack the vertex takes the
  kernels, while CPU tensors, a float64 pack and grad-requiring inputs
  keep the plain `merge_volumes` and launch nothing;
- the wrapper raises on a wrong dtype, shape, device or RNG key;
- the volume rows of `vertex_tables` read back equal the pack (centre,
  axes, half-size, -1/density, kind, each mesh block's offset and rows);
- a numpy reader of those rows that follows the kernel's arithmetic
  (fused multiply-adds emulated in float64) gives merge_volumes's hits
  on every boundary kind, with per-lane bounces and dead lanes.
"""
import numpy as np
import pytest
import torch

from rust_raytracer_torch.core import rng as trng
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.ops import vertex
from rust_raytracer_torch.render import integrator as tint
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.scene import graph as tg
from rust_raytracer_torch.scene import pack as sp

from test_torch_graph import fog_scene
from test_torch_scene import mini_dragon_scene
from test_torch_volumes import SCENES, _rays, one_thread  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

N = 512
F32 = np.float32
SEED = 2 ** 31 + 17   # above 2^31: the key is taken modulo 2^32


@pytest.fixture(autouse=True)
def own_counters(monkeypatch):
    """ops/vertex.py's launch and plain-call counters, which these tests
    advance through stand-in launches, restored after each test: a later
    test of the process reads them from where it found them."""
    monkeypatch.setattr(vertex, "launches", dict(vertex.launches))
    monkeypatch.setattr(vertex, "plain_calls", dict(vertex.plain_calls))


def _compiled(name, dtype=torch.float32):
    make = {"fog": fog_scene, "mini_dragon": mini_dragon_scene, **SCENES}[name]
    return tcompiler.compile_scene(make(tg), "cpu", dtype=dtype)


def _lanes(name, n=N, dtype=torch.float32):
    """n rays around the scene's volumes (the first ones axis-parallel, the
    last 32 dead: zero direction), their RNG key with a bounce a lane."""
    org, dirn = (torch.from_numpy(a).to(dtype) for a in _rays(
        "cornell_smoke" if name == "cornell_smoke" else "sphere", n=n))
    if name == "fog":   # the fog sphere: radius 120 about (200, 150, 250)
        org = org * 50.0 + torch.tensor([200.0, 150.0, 250.0], dtype=dtype)
    dirn[-32:] = 0.0
    g = np.random.default_rng(11)
    ctx = trng.Ctx(torch.arange(n) * 7 + 3, torch.from_numpy(g.integers(0, 225, n)),
                   torch.from_numpy(g.integers(0, 20, n)), SEED)
    return org, dirn, ctx


class Recorder:
    """Stands in for vertex._launch: records (name, pointer tensors)."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, ptrs, ints=(), floats=(), device=None):
        self.calls.append((name, ptrs))

    def names(self):
        return [c[0] for c in self.calls]


def _walk_recorded(monkeypatch, rec):
    """intersect_triangles as a stub that logs "walk" in the recorder and
    returns the plain version's no-triangle result."""
    def walk(pack, org, dirn, t_min, t_max, kernel="auto", return_stats=False, k1_counts=None):
        rec.calls.append(("walk", ()))
        i = torch.full((org.shape[0],), -1, dtype=torch.int32)
        return t_max, i, {"wf_overflow": torch.zeros((), dtype=torch.int64)}

    monkeypatch.setattr(tisect, "intersect_triangles", walk)


# ---------------------------------------------------------------- place in the vertex


@pytest.mark.parametrize("name", ["cornell_smoke", "fog"])
def test_fused_vertex_launches_free_flight_between_hit_and_shade(monkeypatch, name):
    pack, static = _compiled(name)
    org, dirn, ctx = _lanes(name, n=256)
    rec = Recorder()
    monkeypatch.setattr(vertex, "_launch", rec)
    _walk_recorded(monkeypatch, rec)
    before = dict(vertex.launches)
    counters = vertex.new_counters()
    vertex.fused_vertex(pack, static, org, dirn, ctx, 0.25, torch.ones(256, dtype=torch.bool),
                        "auto", tint.T_MIN, counters)
    assert rec.names() == ["rrt_vertex_hit", "walk", "rrt_free_flight", "rrt_vertex_shade"]
    assert {k: vertex.launches[k] - before[k] for k in vertex.KERNELS} == {
        **dict.fromkeys(vertex.KERNELS, 0), "vertex_hit": 1, "free_flight": 1,
        "vertex_shade": 1}
    ff, shade = rec.calls[2][1], rec.calls[3][1]
    t, kind, prim = ff[-3:]
    # KV2's pointers: ftab, itab, tri_attr, org, dirn, t_a, i_a, t_b, i_b,
    # t_c, i_c, kind_in, ...; merged: t_a = t, i_a = prim, kind_in = kind
    assert shade[5] is t and shade[6] is prim and shade[11] is kind
    assert all(x is None for x in shade[7:11])
    # KV2's counter pointers: the counters' volume row, no sphere row (no sphere)
    assert shade[17].data_ptr() == counters[vertex.ROW_VOLUME].data_ptr()
    assert shade[18] is None
    # KV-FF reads KV1's four hits and the walk's two
    hit_out = rec.calls[0][1][-5:-1]
    assert all(a is b for a, b in zip(ff[4:8], hit_out))


def test_scene_without_volumes_launches_nothing_new(monkeypatch):
    pack, static = _compiled("mini_dragon")
    assert pack.vol_kinds == ()
    org, dirn, ctx = _lanes("sphere", n=256)
    rec = Recorder()
    monkeypatch.setattr(vertex, "_launch", rec)
    _walk_recorded(monkeypatch, rec)
    monkeypatch.setattr(tisect, "merge_volumes", lambda *a, **k: pytest.fail("plain merge ran"))
    before = vertex.launches["free_flight"]
    vertex.fused_vertex(pack, static, org, dirn, ctx, 0.25, None, "auto", tint.T_MIN)
    assert rec.names() == ["rrt_vertex_hit", "walk", "rrt_vertex_shade"]
    assert rec.calls[2][1][11] is None   # KV2 merges the hits itself
    assert vertex.launches["free_flight"] == before


# ---------------------------------------------------------------- the route


class OnCard:
    """A tensor's device, dtype and grad flag as a CUDA tensor's would be,
    for the route's decision alone."""

    def __init__(self, t):
        self.device = torch.device("cuda", 0)
        self.dtype, self.requires_grad = t.dtype, t.requires_grad


@pytest.mark.parametrize("case", ["card", "cpu", "float64", "grad"])
def test_route_keeps_plain_merge_off_the_card(monkeypatch, case):
    """shade_vertex on a fog scene: the kernels on the card with a float32
    pack; the plain merge_volumes, and no launch, for CPU tensors, a
    float64 pack and grad-requiring inputs (the route decided as
    use_kernels decides it for the same tensors on the card)."""
    pack, static = _compiled("cornell_smoke", torch.float64 if case == "float64" else
                             torch.float32)
    org, dirn, ctx = _lanes("cornell_smoke", n=256, dtype=pack.dtype)
    if case == "grad":
        org.requires_grad_(True)
    real = vertex.use_kernels
    if case != "cpu":
        monkeypatch.setattr(vertex, "use_kernels",
                            lambda p, *ts: real(p, *(OnCard(t) for t in ts)))
    rec = Recorder()
    monkeypatch.setattr(vertex, "_launch", rec)
    merges = []
    plain = tisect.merge_volumes
    monkeypatch.setattr(tisect, "merge_volumes",
                        lambda *a, **k: merges.append(1) or plain(*a, **k))
    before = (dict(vertex.launches), dict(vertex.plain_calls))
    alive = torch.ones(256, dtype=torch.bool)
    tint.shade_vertex(pack, static, org, dirn, ctx, 0.25, alive)
    launched = {k: vertex.launches[k] - before[0][k] for k in vertex.KERNELS}
    plain_calls = {k: vertex.plain_calls[k] - before[1][k] for k in vertex.KERNELS}
    if case == "card":
        assert "rrt_free_flight" in rec.names() and merges == []
        assert launched["free_flight"] == 1 and plain_calls["free_flight"] == 0
    else:
        assert rec.calls == [] and merges == [1]
        assert launched["free_flight"] == 0 and plain_calls["free_flight"] == 1


# ---------------------------------------------------------------- the wrapper's checks


def _wrapper_inputs(n=256):
    pack, static = _compiled("cornell_smoke")
    org, dirn, ctx = _lanes("cornell_smoke", n=n)
    hits = (torch.zeros(n), torch.zeros(n, dtype=torch.int32), torch.zeros(n),
            torch.zeros(n, dtype=torch.int32), torch.zeros(n),
            torch.full((n,), -1, dtype=torch.int32))
    return pack, static, org, dirn, ctx, hits


def _bad(which, org, dirn, ctx, hits):
    h = list(hits)
    if which == "org float64":
        org = org.double()
    elif which == "dirn shape":
        dirn = dirn[:-1]
    elif which == "hit dtype":
        h[1] = h[1].long()
    elif which == "hit shape":
        h[4] = h[4][:-1]
    elif which == "hit device":
        h[2] = h[2].to("meta")
    elif which == "five hits":
        h = h[:5]
    elif which == "pixel shape":
        ctx = trng.Ctx(ctx.pixel[:1], ctx.sample, ctx.bounce, ctx.seed)
    elif which == "two seeds":
        ctx = trng.Ctx(ctx.pixel, ctx.sample, ctx.bounce, torch.tensor([1, 2]))
    elif which == "bounce shape":
        ctx = trng.Ctx(ctx.pixel, ctx.sample, ctx.bounce[:3], ctx.seed)
    return org, dirn, ctx, tuple(h)


@pytest.mark.parametrize("which", ["org float64", "dirn shape", "hit dtype", "hit shape",
                                   "hit device", "five hits", "pixel shape", "two seeds",
                                   "bounce shape"])
def test_wrapper_raises_on_what_it_cannot_take(monkeypatch, which):
    pack, static, org, dirn, ctx, hits = _wrapper_inputs()
    monkeypatch.setattr(vertex, "_launch", lambda *a, **k: pytest.fail("launched"))
    org, dirn, ctx, hits = _bad(which, org, dirn, ctx, hits)
    with pytest.raises(ValueError):
        vertex.free_flight(pack, static, org, dirn, ctx, tint.T_MIN, hits)


def test_wrapper_launches_with_the_key_and_t_min(monkeypatch):
    pack, static, org, dirn, ctx, hits = _wrapper_inputs()
    args = []
    monkeypatch.setattr(vertex, "_launch", lambda *a: args.append(a))
    t, kind, prim = vertex.free_flight(pack, static, org, dirn, ctx, tint.T_MIN, hits)
    (name, ptrs, ints, floats, dev), = args
    assert name == "rrt_free_flight" and dev == org.device and floats == (tint.T_MIN,)
    assert ints == (256, 1, 0, SEED)   # n, a bounce a lane, its value unused, the seed
    assert all(a is b for a, b in zip(ptrs[-3:], (t, kind, prim)))
    assert ptrs[12] is ctx.bounce and ptrs[13] is None
    assert (t.dtype, kind.dtype, prim.dtype) == (torch.float32, torch.int32, torch.int32)
    # one bounce for every lane (the batch bounce): stride 0, the value passed
    vertex.free_flight(pack, static, org, dirn, trng.Ctx(ctx.pixel, ctx.sample, 7, ctx.seed),
                       tint.T_MIN, hits)
    assert args[1][2] == (256, 0, 7, SEED) and args[1][1][12] is None


# ---------------------------------------------------------------- the table rows


class VolumeRows:
    """The volume rows of ops/vertex.py's tables, read back with numpy."""

    def __init__(self, pack, static):
        self.f, self.i = vertex.table_arrays(pack, static)
        self.n = int(self.i[vertex.H_NVOL])
        off = int(self.i[vertex.H_F_VOL])
        self.rows = self.f[off:off + self.n * vertex.VOL_F].reshape(self.n, vertex.VOL_F)
        off = int(self.i[vertex.H_I_VOLK])
        self.ints = self.i[off:off + self.n * vertex.VOL_I].reshape(self.n, vertex.VOL_I)

    def mesh(self, vi):
        off, count = int(self.ints[vi, 1]), int(self.ints[vi, 2])
        return self.f[off:off + 9 * count].reshape(count, 9)


@pytest.mark.parametrize("name", ["cornell_smoke", "sphere", "mesh", "fog", "mini_dragon"])
def test_volume_rows_round_trip(name):
    pack, static = _compiled(name)
    t = VolumeRows(pack, static)

    def host(x):
        return x.numpy()

    nv = len(pack.vol_kinds)
    assert t.n == nv
    np.testing.assert_array_equal(t.rows[:, 0:3], host(pack.vol_center).reshape(nv, 3))
    np.testing.assert_array_equal(t.rows[:, 3:12], host(pack.vol_axes).reshape(nv, 9))
    np.testing.assert_array_equal(t.rows[:, 12:15], host(pack.vol_halfsize).reshape(nv, 3))
    np.testing.assert_array_equal(t.rows[:, 15], host(pack.vol_neg_inv_density))
    assert tuple(t.ints[:, 0]) == pack.vol_kinds
    for vi, (kind, count) in enumerate(zip(pack.vol_kinds, pack.vol_tri_counts)):
        if kind != sp.VOL_MESH:
            assert tuple(t.ints[vi, 1:]) == (0, 0)
            continue
        assert t.ints[vi, 2] == count > 0
        block = t.mesh(vi)
        for k, f in enumerate(("vol_tri_v0", "vol_tri_e1", "vol_tri_e2")):
            np.testing.assert_array_equal(block[:, 3 * k:3 * k + 3],
                                          host(getattr(pack, f)[vi, :count]))
    if name == "mesh":
        # two blocks, one after the other, neither holding the padding rows
        assert [int(c) for c in t.ints[:, 2]] == [12, 8]
        assert t.ints[1, 1] == t.ints[0, 1] + 9 * 12


# ---------------------------------------------------------------- a reader of the rows


def _fma(a, b, c):
    return (np.float64(a) * b + c).astype(F32)


def _mm(m, v):
    """vertex_common.cuh:matvec_mm of a row-major 3x3 and (n, 3) vectors."""
    return np.stack([_fma(m[r, 2], v[:, 2], _fma(m[r, 1], v[:, 1], F32(m[r, 0] * v[:, 0])))
                     for r in range(3)], axis=1)


def _dot(a, b):
    return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]


def _cross(a, b):
    return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1], a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=1)


def _span(kind, row, block, o, d):
    """csrc/free_flight.cu:boundary_span -> (enter, exit, valid)."""
    if kind == sp.VOL_MESH:
        ts = []
        for r in block:
            v0, e1, e2 = (np.broadcast_to(r[3 * k:3 * k + 3], o.shape) for k in range(3))
            pvec = _cross(d, e2)
            det = _dot(e1, pvec)
            inv = F32(1.0) / np.where(det == 0, F32(1.0), det)
            bvec = o - v0
            u = _dot(bvec, pvec) * inv
            qvec = _cross(bvec, e1)
            w = _dot(d, qvec) * inv
            tt = _dot(e2, qvec) * inv
            ok = (np.abs(det) > F32(1e-12)) & (u >= 0) & (u <= 1) & (w >= 0) & (u + w <= 1)
            ts.append(np.where(ok, tt, F32(np.inf)))
        ts = np.stack(ts, axis=1)
        lo = ts.min(axis=1)
        hi = np.where(ts > (lo + F32(1e-6))[:, None], ts, F32(np.inf)).min(axis=1)
        valid = np.isfinite(lo) & np.isfinite(hi)
        return np.where(valid, lo, F32(0)), np.where(valid, hi, F32(0)), valid
    axes = row[3:12].reshape(3, 3)
    oc, dl = _mm(axes, o - row[0:3]), _mm(axes, d)
    if kind == sp.VOL_SPHERE:
        a, half_b, c = _dot(dl, dl), _dot(dl, oc), _dot(oc, oc) - F32(1.0)
        disc = half_b * half_b - a * c
        sq = np.sqrt(np.maximum(disc, F32(0)))
        a = np.where(a == 0, F32(1.0), a)
        return (-half_b - sq) / a, (-half_b + sq) / a, disc > 0
    inv = F32(1.0) / dl
    t0, t1 = (-row[12:15] - oc) * inv, (row[12:15] - oc) * inv
    enter, exit_ = np.minimum(t0, t1).max(axis=1), np.maximum(t0, t1).min(axis=1)
    return enter, exit_, enter < exit_


def read_free_flight(rows, org, dirn, ctx, t_min, hits):
    """The kernel's (t, kind, prim) from the table rows, lane-parallel."""
    o, d = org.numpy(), dirn.numpy()
    ts, i_s, tp, i_p, tt, i_t = (h.numpy() for h in hits)
    tt = np.where(i_t >= 0, tt, F32(np.inf))
    t = np.minimum(np.minimum(ts, tp), tt)
    is_s, is_p = ts <= t, tp <= t
    kind = np.where(is_s, sp.PRIM_SPHERE, np.where(is_p, sp.PRIM_PLANE, sp.PRIM_TRIANGLE))
    prim = np.where(is_s, i_s, np.where(is_p, i_p, i_t))
    fin = np.isfinite(t)
    kind, prim = np.where(fin, kind, sp.PRIM_NONE), np.where(fin, prim, -1)
    ray_len = np.sqrt(_dot(d, d))
    best_t, best_i = t, np.full(t.shape, -1)
    for vi in range(rows.n):
        enter, exit_, valid = _span(rows.ints[vi, 0], rows.rows[vi], rows.mesh(vi), o, d)
        lo = np.maximum(np.maximum(enter, F32(t_min)), F32(0))
        hi = np.minimum(exit_, best_t)
        inside = valid & (lo < hi)
        u = ctx.uniform(trng.Streams.VOLUME + 16 * vi).numpy()
        hit_dist = rows.rows[vi, 15] * np.log(np.maximum(u, F32(1e-30)))
        hit = inside & (hit_dist <= (hi - lo) * ray_len)
        best_i = np.where(hit, vi, best_i)
        best_t = np.where(hit, lo + hit_dist / ray_len, best_t)
    vol = best_i >= 0
    return np.where(vol, best_t, t), np.where(vol, sp.PRIM_VOLUME, kind), np.where(vol, best_i,
                                                                                  prim)


@pytest.mark.parametrize("name", ["cornell_smoke", "sphere", "mesh", "fog"])
def test_reader_of_the_rows_equals_merge_volumes(name):
    pack, static = _compiled(name)
    org, dirn, ctx = _lanes(name, n=2048)
    tl = torch.full((org.shape[0],), tint.T_MIN)
    t_sph, i_sph, t_pln, i_pln, tri_tmax = tisect.analytic_hits(pack, org, dirn, tl)
    t_tri, i_tri = tisect.intersect_triangles(pack, org, dirn, tint.T_MIN, tri_tmax)
    hits = (t_sph, i_sph, t_pln, i_pln, t_tri, i_tri)
    want = tisect.merge_volumes(pack, org, dirn, tl, ctx, *hits)
    with np.errstate(all="ignore"):
        got = read_free_flight(VolumeRows(pack, static), org, dirn, ctx, tint.T_MIN, hits)
    w_t, w_kind, w_prim = (x.numpy() for x in want)
    agree = (got[1] == w_kind) & (got[2] == w_prim)
    assert agree.mean() >= 0.999, agree.mean()
    assert (w_kind == sp.PRIM_VOLUME).sum() > 50   # the volumes are crossed
    assert {int(k) for k in np.unique(w_prim[w_kind == sp.PRIM_VOLUME])} == set(
        range(len(pack.vol_kinds)))
    np.testing.assert_allclose(got[0][agree], w_t[agree], rtol=1e-5, atol=1e-6)
