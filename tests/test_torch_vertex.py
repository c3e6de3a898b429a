"""The path vertex kernels' scene tables and routing (ops/vertex.py) on
the CPU.

The kernels (csrc/vertex_hit.cu, vertex_shade.cu, lane_update.cu,
pool_refill.cu) run only on the card, where chip_smoke.py and
scripts/vertex_parity.py hold them against their plain versions.  Here:

- `vertex_tables` on every builtin scene that builds without a download,
  the texture scene (every node kind) and the fog scene (volumes): the
  header's counts and every row read back equal the pack and the
  SceneStatic;
- a numpy reader of the tables, one lane at a time at N = 256, that
  evaluates the texture program and the light pdf and sample from the
  table layout (the layout the shading kernel reads) equals the port's
  eval_program / lights_* (atol and rtol 1e-6) and the JAX package's (at
  tests/test_torch_shade.py's rtol 1e-5, atol 1e-6);
- the texture closure bound: every builtin's closures fit MAX_NODES, a
  program of any length builds, a closure longer than MAX_NODES raises
  ValueError (tests/test_torch_monkey_cell.py holds the closures against
  eval_program);
- the CPU route: shade_vertex, bounce_step and the pool step equal the code
  they replaced bit for bit (copies of it below), and count plain calls;
- no fallback: a kernel library that fails to load raises out of every
  wrapper;
- the tables are built when the step or the batch program is made, not
  inside a step.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytracer_tpu.ops import lights as jlights
from rust_raytracer_tpu.ops import texture as jtex
from rust_raytracer_tpu.scene import compiler as jcompiler
from rust_raytracer_torch import models
from rust_raytracer_torch.core import math as vmath
from rust_raytracer_torch.core import rng as trng
from rust_raytracer_torch.ops import _cuda
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.ops import lights as tlights
from rust_raytracer_torch.ops import texture as ttex
from rust_raytracer_torch.ops import vertex
from rust_raytracer_torch.render import integrator as tint
from rust_raytracer_torch.render import pool as tpool
from rust_raytracer_torch.render import renderer as trend
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.scene import graph as tg
from rust_raytracer_torch.scene import pack as sp

from test_torch_graph import camera_of, fog_scene
from test_torch_scene import (jax_graph, mini_dragon_scene, port_pack_from_jax, port_static,
                              texture_scene)

torch.set_num_threads(2)

N = 256
# the builtin scenes that build from the repository alone (the others read
# assets that are not checked in)
BUILTINS = ("cornell", "cornell_dragon", "cornell_smoke", "test", "tonemap_test")
F32 = np.float32


@pytest.fixture(scope="module")
def texture_pack():
    jp, js = jcompiler.compile_scene(texture_scene(jax_graph()))
    return jp, js, port_pack_from_jax(jp), port_static(js)


# ---------------------------------------------------------------- the reader

class Tables:
    """ops/vertex.py's tables read back with numpy."""

    def __init__(self, pack, static):
        self.f, self.i = vertex.table_arrays(pack, static)

    def h(self, k):
        return int(self.i[k])

    def frows(self, off_key, count, width):
        off = self.h(off_key)
        return self.f[off:off + count * width].reshape(count, width)

    def irows(self, off_key, count, width):
        off = self.h(off_key)
        return self.i[off:off + count * width].reshape(count, width)

    def sphere(self, kind, li):
        if kind == sp.LIGHT_PROXY:
            row = self.frows(vertex.H_F_PROXY, self.h(vertex.H_NPROXY), vertex.PROXY_F)[li]
        else:
            row = self.frows(vertex.H_F_SPH, self.h(vertex.H_NS), vertex.SPH_F)[li]
        return row[0:3], row[3]

    def plane(self, li):
        row = self.frows(vertex.H_F_PLN, self.h(vertex.H_NP), vertex.PLN_F)[li]
        back = self.irows(vertex.H_I_PLN, self.h(vertex.H_NP), vertex.PLN_I)[li, 0]
        return row, bool(back)

    def lights(self):
        return self.irows(vertex.H_I_LIGHT, self.h(vertex.H_NLIGHT), vertex.LIGHT_I)


def f3(*a):
    return np.array(a, F32)


def dot(a, b):
    return F32(F32(F32(a[0] * b[0]) + F32(a[1] * b[1])) + F32(a[2] * b[2]))


def perlin(p, grad, perm):
    pf = np.floor(p)
    uvw = (p - pf).astype(F32)
    ijk = pf.astype(np.int64)
    s = (uvw * uvw) * (F32(3.0) - F32(2.0) * uvw)
    acc = F32(0.0)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                g = grad[perm[(ijk[0] + di) & 255] ^ perm[256 + ((ijk[1] + dj) & 255)]
                         ^ perm[512 + ((ijk[2] + dk) & 255)]]
                w = ((F32(di) * s[0] + F32(1 - di) * (F32(1) - s[0]))
                     * (F32(dj) * s[1] + F32(1 - dj) * (F32(1) - s[1]))
                     * (F32(dk) * s[2] + F32(1 - dk) * (F32(1) - s[2])))
                acc = F32(acc + w * dot(g, uvw - f3(di, dj, dk)))
    return acc


def node_value(t: Tables, k, kids, uv, pos):
    """Node k's value at one lane from the tables, `kids` the values of its
    children c0 c1 c2 (as many as it has)."""
    r = t.irows(vertex.H_I_NODE, t.h(vertex.H_NNODE), vertex.NODE_I)[k]
    scale = F32(t.frows(vertex.H_F_NODE, t.h(vertex.H_NNODE), vertex.NODE_F)[k, 0])
    kind = r[0]
    if kind == ttex.CONSTANT:
        v = t.frows(vertex.H_F_CONST, k + 1, 3)[k]
    elif kind == ttex.CHECKER:
        iu = int(min(max(F32(uv[0] * F32(2)) / scale, F32(0)), F32(2.0**31)))
        iv = int(min(max(F32(uv[1] * F32(2)) / scale, F32(0)), F32(2.0**31)))
        v = kids[0] if (iu + iv) % 2 == 0 else kids[1]
    elif kind == ttex.CHECKER_SOLID:
        ijk = np.floor((pos / scale).astype(F32)).astype(np.int64)
        v = kids[0] if int(ijk.sum()) % 2 == 0 else kids[1]
    elif kind == ttex.IMAGE:
        h, w = int(r[5]), int(r[6])
        px = t.f[r[4]:r[4] + h * w * 3].reshape(h, w, 3)
        u, vv = uv
        if r[7]:
            u, vv = min(max(u, F32(0)), F32(1)), min(max(vv, F32(0)), F32(1))
        else:
            u, vv = F32(u - np.floor(u)), F32(vv - np.floor(vv))
        v = px[int(F32(vv * F32(h - 0.001))), int(F32(u * F32(w - 0.001)))]
    elif kind == ttex.LERP:
        tt = kids[2][0]
        v = kids[0] * (F32(1) - tt) + kids[1] * tt
    elif kind == ttex.NOISE_SOLID:
        grad = t.f[r[4]:r[4] + 256 * 3].reshape(256, 3)
        perm = t.i[r[5]:r[5] + 3 * 256]
        ps = (pos * scale).astype(F32)
        acc, weight, pp = F32(0), F32(1), ps
        for _ in range(r[6]):
            acc = F32(acc + weight * perlin(pp, grad, perm))
            weight = F32(weight * F32(0.5))
            pp = (pp * F32(2)).astype(F32)
        turb = abs(acc)
        s = F32(0.5) * (F32(1) + np.sin(F32(ps[2] + F32(10) * turb))) if r[7] == 0 else turb
        v = f3(s, s, s)
    elif kind == ttex.CHANNEL:
        v = f3(*[kids[0][r[4]]] * 3)
    else:
        v = f3(uv[0], uv[1], 0.5)
    return np.asarray(v, F32)


def read_program(t: Tables, uv, pos):
    """The program's (nodes, 3) values at one lane, from the tables alone."""
    nn = t.h(vertex.H_NNODE)
    nodes_i = t.irows(vertex.H_I_NODE, nn, vertex.NODE_I)
    val = []
    for k in range(nn):
        kids = [val[c] if c < k else None for c in nodes_i[k, 1:4]]
        val.append(node_value(t, k, kids, uv, pos))
    return np.stack(val) if val else np.zeros((1, 3), F32)


def read_closure(t: Tables, key, uv, pos):
    """(albedo, roughness, normal map or None, emission or None) of shading
    key `key` at one lane, as the shading kernel reads them: only the nodes
    of the key's closure, each child at its position in the closure."""
    n_keys = t.h(vertex.H_NMAT) + t.h(vertex.H_NSKY) + t.h(vertex.H_NSUN)
    row = t.irows(vertex.H_I_CLOS, n_keys, vertex.CLOS_I)[key]
    entries = t.i[row[0]:row[0] + row[1] * vertex.CLOS_E].reshape(-1, vertex.CLOS_E)
    val = []
    for e in entries:
        kids = [val[p] if p < len(val) else None for p in e[1:4]]
        val.append(node_value(t, e[0], kids, uv, pos))
    if not val:
        val = [np.zeros(3, F32)]
    return tuple(None if p < 0 else val[p] for p in row[2:6])


def sphere_t(o, d, c, r):
    oc = (o - c).astype(F32)
    a, half_b = dot(d, d), dot(d, oc)
    cc = F32(dot(oc, oc) - F32(r * r))
    disc = F32(half_b * half_b - a * cc)
    if disc < 0:
        return math.inf
    sq = np.sqrt(disc) if disc > 0 else F32(0)
    for root in (F32((-half_b - sq) / a), F32((-half_b + sq) / a)):
        if F32(1e-3) < root < math.inf:
            return root
    return math.inf


def plane_t(o, d, row, back):
    corner, dual_u, dual_v, nrm = row[0:3], row[9:12], row[12:15], row[15:18]
    dot_rn = dot(nrm, d)
    dd = abs(dot_rn) if back else -dot_rn
    t = dot(nrm, (corner - o).astype(F32)) / (dot_rn if abs(dot_rn) > F32(1e-12) else F32(1))
    if not (dd > F32(1e-12) and F32(1e-3) < t < math.inf):
        return math.inf
    local = ((o + d * t).astype(F32) - corner).astype(F32)
    u, v = dot(local, dual_u), dot(local, dual_v)
    return t if 0 <= u <= 1 and 0 <= v <= 1 else math.inf


def read_pdf(t: Tables, o, d):
    """lights_pdf_value at one lane from the tables."""
    lts = t.lights()
    acc = F32(0)
    for kind, li in lts:
        if kind in (sp.LIGHT_SPHERE, sp.LIGHT_PROXY):
            c, r = t.sphere(kind, li)
            hits = math.isfinite(sphere_t(o, d, c, r))
            d2 = dot(c - o, c - o)
            ctm = np.sqrt(max(F32(1) - F32(r * r) / max(d2, F32(1e-20)), F32(1e-20)))
            sa = F32(F32(2 * math.pi) * (F32(1) - ctm))
            acc = F32(acc + (F32(1) / sa if hits and sa > 0 else F32(0)))
        elif kind == sp.LIGHT_PLANE:
            row, back = t.plane(li)
            tt = plane_t(o, d, row, back)
            hits = math.isfinite(tt)
            ts = F32(tt) if hits else F32(1)
            cosine = F32(abs(dot(d, row[15:18])) / np.sqrt(max(dot(d, d), F32(1e-20))))
            pdf = F32(F32(ts * ts) * dot(d, d)) / F32((cosine if cosine > 0 else F32(1)) * row[18])
            acc = F32(acc + (pdf if hits and cosine > 0 else F32(0)))
        elif kind == sp.LIGHT_SKY:
            acc = F32(acc + F32(1 / (4 * math.pi)))
        else:
            acc = F32(acc + F32(1))
    return acc / F32(len(lts))


def onb(w):
    use_y = F32(1) if abs(w[0]) > F32(0.9) else F32(0)
    a = f3(1 - use_y, use_y, 0)
    c = np.cross(w, a).astype(F32)
    v = (c / np.sqrt(dot(c, c))).astype(F32)
    return np.cross(w, v).astype(F32), v


def read_sample(t: Tables, o, pick_u, u):
    """lights_sample at one lane from the tables, given the lane's light
    pick uniform and the LIGHT_SAMPLE + slot uniforms `u[slot]`."""
    lts = t.lights()
    slot = min(int(F32(pick_u * F32(len(lts)))), len(lts) - 1)
    kind, li = lts[slot]
    u1, u2 = u[slot][0], u[slot][1]
    if kind in (sp.LIGHT_SPHERE, sp.LIGHT_PROXY):
        c, r = t.sphere(kind, li)
        to_c = (c - o).astype(F32)
        ctm = np.sqrt(max(F32(1) - F32(r * r) / max(dot(to_c, to_c), F32(1e-20)), F32(1e-20)))
        phi = F32(F32(u1 * F32(2)) * F32(math.pi))
        z = F32(1) + u2 * F32(ctm - F32(1))
        rr = np.sqrt(max(F32(1) - z * z, F32(1e-20)))
        local = f3(rr * np.cos(phi), rr * np.sin(phi), z)
        w = (to_c / np.sqrt(max(dot(to_c, to_c), F32(1e-40)))).astype(F32)
        bu, bv = onb(w)
        return bu * local[0] + bv * local[1] + w * local[2]
    if kind == sp.LIGHT_PLANE:
        row, _ = t.plane(li)
        return (row[0:3] + row[3:6] * u1 + row[6:9] * u2).astype(F32) - o
    if kind == sp.LIGHT_SKY:
        z = F32(1) - F32(2) * u1
        rr = np.sqrt(max(F32(1) - z * z, F32(1e-20)))
        phi = F32(F32(2 * math.pi) * u2)
        return f3(rr * np.cos(phi), rr * np.sin(phi), z)
    return t.frows(vertex.H_F_SUN, t.h(vertex.H_NSUN), vertex.SUN_F)[li]


# ---------------------------------------------------------------- tables

def check_tables(pack, static):
    """Every count and row of the tables equal to the pack's fields."""
    t = Tables(pack, static)
    assert t.f.dtype == np.float32 and t.i.dtype == np.int32

    def host(x):
        return x.numpy()

    counts = {vertex.H_NS: pack.sph_center.shape[0], vertex.H_NP: pack.pln_corner.shape[0],
              vertex.H_NT: pack.tri_attr.shape[0], vertex.H_NVOL: pack.vol_kind.shape[0],
              vertex.H_NSKY: pack.sky_tex.shape[0], vertex.H_NSUN: pack.sun_dir.shape[0],
              vertex.H_NMAT: pack.mat_type.shape[0], vertex.H_NLIGHT: len(static.light_list),
              vertex.H_NNODE: len(static.tex_program),
              vertex.H_NPROXY: pack.lgt_sph_center.shape[0]}
    for k, v in counts.items():
        assert t.h(k) == v, k
    ns, npl = counts[vertex.H_NS], counts[vertex.H_NP]
    sph = t.frows(vertex.H_F_SPH, ns, vertex.SPH_F)
    np.testing.assert_array_equal(sph[:, 0:3], host(pack.sph_center))
    np.testing.assert_array_equal(sph[:, 3], host(pack.sph_radius))
    if pack.sph_inv.shape[0]:
        np.testing.assert_array_equal(sph[:, 4:13], host(pack.sph_inv).reshape(ns, 9))
    np.testing.assert_array_equal(t.irows(vertex.H_I_SPH, ns, 1)[:, 0], host(pack.sph_mat))
    pln = t.frows(vertex.H_F_PLN, npl, vertex.PLN_F)
    for k, f in enumerate(("pln_corner", "pln_uhalf", "pln_vhalf", "pln_dual_u", "pln_dual_v",
                           "pln_normal")):
        np.testing.assert_array_equal(pln[:, 3 * k:3 * k + 3], host(getattr(pack, f)))
    np.testing.assert_array_equal(pln[:, 18], host(pack.pln_area))
    pi = t.irows(vertex.H_I_PLN, npl, vertex.PLN_I)
    np.testing.assert_array_equal(pi[:, 0], host(pack.pln_backface))
    np.testing.assert_array_equal(pi[:, 1], host(pack.pln_mat))
    nm = counts[vertex.H_NMAT]
    mi = t.irows(vertex.H_I_MAT, nm, vertex.MAT_I)
    mf = t.frows(vertex.H_F_MAT, nm, vertex.MAT_F)
    np.testing.assert_array_equal(mi[:, 0], host(pack.mat_type))
    np.testing.assert_array_equal(mf[:, 0], host(pack.mat_inv_ior))
    np.testing.assert_array_equal(mf[:, 1], host(pack.mat_ior))
    assert [tuple(r) for r in t.lights()] == [tuple(x) for x in static.light_list]
    np.testing.assert_array_equal(t.irows(vertex.H_I_VOL, counts[vertex.H_NVOL], 1)[:, 0],
                                  host(pack.vol_mat))
    np.testing.assert_array_equal(t.frows(vertex.H_F_SUN, counts[vertex.H_NSUN], 3),
                                  host(pack.sun_dir))
    np.testing.assert_array_equal(t.frows(vertex.H_F_BG, 1, 3)[0], host(pack.background))
    nodes = t.irows(vertex.H_I_NODE, counts[vertex.H_NNODE], vertex.NODE_I)
    for k, node in enumerate(static.tex_program):
        assert nodes[k, 0] == node.kind
        assert tuple(nodes[k, 1:1 + len(node.children)]) == node.children
        if node.kind == ttex.CONSTANT:
            np.testing.assert_array_equal(t.frows(vertex.H_F_CONST, k + 1, 3)[k],
                                          host(pack.tex_const)[k])
    # every texture root (materials', skies', suns'), through the closure
    # rows, KV2's only record of them
    n_keys = nm + counts[vertex.H_NSKY] + counts[vertex.H_NSUN]
    rows = t.irows(vertex.H_I_CLOS, n_keys, vertex.CLOS_I)
    for key in range(n_keys):
        nodes = t.i[rows[key, 0]:rows[key, 0] + rows[key, 1] * vertex.CLOS_E][::vertex.CLOS_E]
        got = [None if p < 0 else int(nodes[p]) if len(nodes) else 0 for p in rows[key, 2:6]]
        assert got == list(pack_roots(pack, key)), key
    return t


def pack_roots(pack, key):
    """(albedo, roughness, normal map or None, emission or None) node ids of
    shading key `key` from the pack: a material, then each sky, then each
    sun (whose lanes read material 0's roots)."""
    nmat, nsky = pack.mat_type.shape[0], pack.sky_tex.shape[0]
    m = key if key < nmat else 0
    normal = int(pack.mat_normal_tex[m])
    emit = (None if key < nmat else int(pack.sky_tex[key - nmat]) if key < nmat + nsky
            else int(pack.sun_tex[key - nmat - nsky]))
    return (int(pack.mat_albedo_tex[m]), int(pack.mat_rough_tex[m]),
            normal if normal >= 0 else None, emit)


@pytest.mark.parametrize("name", BUILTINS)
def test_tables_builtin(name):
    pack, static = tcompiler.compile_scene(models.build(name), "cpu")
    check_tables(pack, static)
    assert max(len(nodes) for nodes, _ in closures_of(pack, static)) <= vertex.MAX_NODES


def test_tables_texture_and_fog(texture_pack):
    _, _, tp, ts = texture_pack
    t = check_tables(tp, ts)
    kinds = set(t.irows(vertex.H_I_NODE, len(ts.tex_program), vertex.NODE_I)[:, 0])
    assert set(range(8)) <= kinds
    fp, fs = tcompiler.compile_scene(fog_scene(tg), "cpu")
    t = check_tables(fp, fs)
    assert t.h(vertex.H_NVOL) == 1


def closures_of(pack, static):
    return vertex.texture_closures(static.tex_program, *(getattr(pack, f).numpy() for f in (
        "mat_albedo_tex", "mat_rough_tex", "mat_normal_tex", "sky_tex", "sun_tex")))


def test_node_bound_raises():
    """MAX_NODES bounds one shading key's closure, not the program: every
    builtin's closures fit; a program grown by MAX_NODES + 1 nodes that no
    root reaches builds its tables; one whose material 0 albedo reaches
    more than MAX_NODES nodes raises ValueError."""
    longest = max(len(nodes) for n in ("cornell", "test", "tonemap_test")
                  for nodes, _ in closures_of(*tcompiler.compile_scene(models.build(n), "cpu")))
    assert longest <= vertex.MAX_NODES
    pack, static = tcompiler.compile_scene(models.build("test"), "cpu")
    n = len(static.tex_program)
    extra = (ttex.TexNode(ttex.CONSTANT),) * (vertex.MAX_NODES + 1)
    t = Tables(pack, dataclasses.replace(static, tex_program=static.tex_program + extra))
    assert t.h(vertex.H_NNODE) == n + vertex.MAX_NODES + 1
    chain = [ttex.TexNode(ttex.CONSTANT)]
    for k in range(vertex.MAX_NODES):
        chain.append(ttex.TexNode(ttex.CHECKER, children=(n + k, n), scale=0.5))
    deep = dataclasses.replace(static, tex_program=static.tex_program + tuple(chain))
    albedo = pack.mat_albedo_tex.clone()
    albedo[0] = n + vertex.MAX_NODES
    assert len(closures_of(pack._replace(mat_albedo_tex=albedo), deep)[0][0]) \
        > vertex.MAX_NODES
    with pytest.raises(ValueError, match="at most"):
        vertex.vertex_tables(pack._replace(mat_albedo_tex=albedo), deep)
    vertex.vertex_tables(pack, deep)   # the chain reached by no root builds


def test_reader_texture_program(texture_pack):
    jp, js, tp, ts = texture_pack
    rng = np.random.default_rng(14)
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(F32)
    pos = rng.uniform(-3, 3, (N, 3)).astype(F32)
    t = Tables(tp, ts)
    got = np.stack([read_program(t, uv[k], pos[k]) for k in range(N)], axis=1)
    want = ttex.eval_program(ts.tex_program, tp.tex_data, torch.from_numpy(uv),
                             torch.from_numpy(pos), tex_const=tp.tex_const).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    jwant = jtex.eval_program(js.tex_program, jp.tex_data, jnp.asarray(uv), jnp.asarray(pos),
                              tex_const=jp.tex_const)
    np.testing.assert_allclose(got, np.asarray(jwant), rtol=1e-5, atol=1e-6)


def test_reader_lights(texture_pack):
    jp, js, tp, ts = texture_pack
    rng = np.random.default_rng(15)
    org = rng.uniform(-2, 2, (N, 3)).astype(F32)
    pix = np.arange(N, dtype=np.int64) * 37 + 11
    ctx = trng.Ctx(torch.from_numpy(pix), torch.from_numpy(pix % 7), 2, 5)
    t = Tables(tp, ts)
    pick = ctx.uniform(trng.Streams.LIGHT_PICK).numpy()
    u = [np.stack([x.numpy() for x in ctx.uniform4(trng.Streams.LIGHT_SAMPLE + s)], 1)
         for s in range(len(ts.light_list))]
    got = np.stack([read_sample(t, org[k], pick[k], [x[k] for x in u]) for k in range(N)])
    want = tlights.lights_sample(tp, ts.light_list, torch.from_numpy(org), ctx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for dirn in (want, rng.normal(size=(N, 3)).astype(F32)):
        got = np.array([read_pdf(t, org[k], dirn[k]) for k in range(N)])
        want_p = tlights.lights_pdf_value(tp, ts.light_list, torch.from_numpy(org),
                                          torch.from_numpy(dirn)).numpy()
        np.testing.assert_allclose(got, want_p, rtol=1e-6, atol=1e-6)
        jwant = jlights.lights_pdf_value(jp, js.light_list, jnp.asarray(org), jnp.asarray(dirn))
        np.testing.assert_allclose(got, np.asarray(jwant), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- the CPU route

def old_intersect(pack, org, dirn, t_min, ctx, alive, kernel):
    """ops/intersect.py:_intersect as it stood before the vertex kernels."""
    n = org.shape[0]
    inf = torch.full((n,), float("inf"))
    tl = torch.full((n,), t_min)
    t_sph, i_sph = tisect.intersect_spheres(pack, org, dirn, tl, inf)
    t_pln, i_pln = tisect.intersect_planes(pack, org, dirn, tl, inf)
    tri_tmax = torch.minimum(t_sph, t_pln)
    tri_tmax = torch.where(alive, tri_tmax, torch.zeros_like(tri_tmax))
    t_tri, i_tri, stats = tisect.intersect_triangles(pack, org, dirn, t_min, tri_tmax,
                                                     kernel=kernel, return_stats=True)
    t_tri = torch.where(i_tri >= 0, t_tri, inf)
    t_best = torch.minimum(torch.minimum(t_sph, t_pln), t_tri)
    is_s, is_p = t_sph <= t_best, t_pln <= t_best
    kind = torch.where(is_s, sp.PRIM_SPHERE,
                       torch.where(is_p, sp.PRIM_PLANE, sp.PRIM_TRIANGLE)).to(torch.int32)
    prim = torch.where(is_s, i_sph, torch.where(is_p, i_pln, i_tri))
    finite = torch.isfinite(t_best)
    kind = torch.where(finite, kind, sp.PRIM_NONE).to(torch.int32)
    prim = torch.where(finite, prim, -1).to(torch.int32)
    if pack.vol_kinds:
        t_vol, i_vol = tisect.intersect_volumes(pack, org, dirn, tl, t_best, ctx)
        vol_hit = i_vol >= 0
        t_best = torch.where(vol_hit, t_vol, t_best)
        kind = torch.where(vol_hit, sp.PRIM_VOLUME, kind).to(torch.int32)
        prim = torch.where(vol_hit, i_vol, prim).to(torch.int32)
    if pack.sun_dir.shape[0]:
        unit_d = vmath.normalize(dirn)
        miss = ~torch.isfinite(t_best)
        for ui in range(pack.sun_dir.shape[0]):
            cos = vmath.dot(unit_d, pack.sun_dir[ui].expand_as(unit_d))
            take = miss & (torch.abs(cos - 1.0) <= tisect.SUN_THETA_MAX)
            t_best = torch.where(take, tisect.T_SUN, t_best)
            kind = torch.where(take, sp.PRIM_SUN, kind).to(torch.int32)
            prim = torch.where(take, ui, prim).to(torch.int32)
            miss = miss & ~take
    if pack.sky_tex.shape[0]:
        miss = ~torch.isfinite(t_best)
        kind = torch.where(miss, sp.PRIM_SKY, kind).to(torch.int32)
        prim = torch.where(miss, pack.sky_tex.shape[0] - 1, prim).to(torch.int32)
        t_best = torch.where(miss, float("inf"), t_best)
    return tisect.Hit(t_best, kind, prim), stats


def old_step(pack, static, camera, total, spp, seed, kernel):
    """render/pool.py's step as it stood before the vertex kernels."""
    w, max_depth, lb = camera.image_width, camera.max_depth, camera.light_bias

    def step(s):
        ctx = trng.Ctx(pixel=s.pixel, sample=s.sample, bounce=s.bounce, seed=seed)
        with torch.no_grad():
            hit, stats = old_intersect(pack, s.org, s.dirn, tint.T_MIN, ctx, s.active, kernel)
        emission, weight, new_dir, ended, pos = tint.shade_hits(pack, static, s.org, s.dirn,
                                                                hit, ctx, lb)
        overflow = s.overflow + stats["wf_overflow"]
        act = s.active[:, None]
        radiance = s.radiance + s.throughput * emission * act
        throughput = s.throughput * torch.where(act, weight, 0.0)
        bounce = s.bounce + 1
        still = s.active & ~ended & (bounce < max_depth)
        org = torch.where(still[:, None], pos, s.org)
        dirn = torch.where(still[:, None], new_dir, s.dirn)
        retired = s.active & ~still
        perm = torch.sort(tint._compaction_key(org, dirn, still), stable=True).indices
        org, dirn, throughput, radiance = org[perm], dirn[perm], throughput[perm], radiance[perm]
        pixel, sample, bounce = s.pixel[perm], s.sample[perm], bounce[perm]
        still, retired = still[perm], retired[perm]
        accum = s.accum.index_add(0, pixel, torch.where(retired[:, None], radiance, 0.0))
        dead = ~still
        rank = torch.cumsum(dead.to(torch.int64), 0) - 1
        new_local = s.next_flat + rank
        issue = dead & (new_local < total)
        pix, smp = new_local // spp, new_local % spp
        ctx0 = trng.Ctx(pixel=pix, sample=smp, bounce=0, seed=seed)
        g_org, g_dir = camera.generate_rays(pix % w, pix // w, smp, ctx0, s.org.dtype)
        iss = issue[:, None]
        return tpool.PoolState(
            org=torch.where(iss, g_org, org), dirn=torch.where(iss, g_dir, dirn),
            throughput=torch.where(iss, 1.0, throughput),
            radiance=torch.where(iss | retired[:, None], 0.0, radiance),
            pixel=torch.where(issue, pix, pixel), sample=torch.where(issue, smp, sample),
            bounce=torch.where(issue, 0, bounce), active=still | issue, accum=accum,
            next_flat=torch.clamp(s.next_flat + dead.sum(), max=total), overflow=overflow)

    return step


@pytest.fixture(scope="module")
def scenes():
    """name -> (pack, static, camera) on the CPU; the texture scene's camera
    has an aperture (the refill's rim draw)."""
    from rust_raytracer_torch.render.camera import Camera

    out = {}
    for name, make in (("mini_dragon", mini_dragon_scene), ("fog", fog_scene),
                       ("texture", texture_scene)):
        scene = make(tg)
        pack, static = tcompiler.compile_scene(scene, "cpu")
        cam = camera_of(scene) if name != "texture" else Camera(
            image_width=16, aspect_ratio=1.0, samples_per_pixel=2, max_depth=8,
            position=(0.0, 1.0, 7.0), look_at=(0.0, 0.0, 0.0), focal_length=35.0, f_number=8.0)
        out[name] = (pack, static, cam)
    return out


def assert_states_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(x, y) or (x.is_floating_point() and torch.equal(
            torch.nan_to_num(x, 7.0), torch.nan_to_num(y, 7.0))), f


@pytest.mark.parametrize("name", ["mini_dragon", "fog", "texture"])
def test_cpu_pool_step_equals_old_step(scenes, name):
    pack, static, cam = scenes[name]
    total = cam.image_width * cam.image_height * 2
    before = dict(vertex.plain_calls)
    step = tpool.make_step(pack, static, cam, total, 2, 3, kernel="auto")
    old = old_step(pack, static, cam, total, 2, 3, "auto")
    a = b = tpool.init_state(128, cam.image_width * cam.image_height, "cpu")
    for _ in range(6):
        a, b = step(pack, a), old(b)
        assert_states_equal(a, b)
    assert "_vertex_tables" not in pack.__dict__  # the CPU route builds no table
    assert {k: vertex.plain_calls[k] - before[k] for k in vertex.KERNELS} == {
        **dict.fromkeys(vertex.KERNELS, 6), "free_flight": 6 if pack.vol_kinds else 0}
    assert vertex.launches == dict.fromkeys(vertex.KERNELS, 0)


@pytest.mark.parametrize("name", ["mini_dragon", "fog", "texture"])
def test_cpu_bounce_and_vertex_equal_old_code(scenes, name):
    pack, static, cam = scenes[name]
    n = 192
    rng = np.random.default_rng(3)
    px = torch.from_numpy(rng.integers(0, cam.image_width, n))
    py = torch.from_numpy(rng.integers(0, cam.image_height, n))
    smp = torch.from_numpy(rng.integers(0, 4, n))
    ctx = trng.Ctx(pixel=py * cam.image_width + px, sample=smp, bounce=0, seed=9)
    org, dirn = cam.generate_rays(px, py, smp, ctx)
    alive = torch.from_numpy(rng.uniform(size=n) < 0.8)
    got = tint.shade_vertex(pack, static, org, dirn, ctx, cam.light_bias, alive)
    hit, _ = old_intersect(pack, org, dirn, tint.T_MIN, ctx, alive, "auto")
    want = tint.shade_hits(pack, static, org, dirn, hit, ctx, cam.light_bias)
    for x, y in zip(got[:5], want):
        assert torch.equal(torch.nan_to_num(x, 7.0), torch.nan_to_num(y, 7.0))

    s = tint.start_state(org, dirn, ctx)
    step = tint.bounce_step(static, cam.light_bias, True, "auto")
    old = s
    for depth in range(4):
        s = step(pack, s)
        perm = torch.sort(tint._compaction_key(old.org, old.dirn, old.alive),
                          stable=True).indices
        old = tint.BounceState(*(x[perm] for x in old[:-2]), depth=old.depth, seed=old.seed)
        octx = trng.Ctx(pixel=old.pixel, sample=old.sample, bounce=old.depth, seed=old.seed)
        with torch.no_grad():
            hit, _ = old_intersect(pack, old.org, old.dirn, tint.T_MIN, octx, old.alive, "auto")
        em, wt, nd, ended, pos = tint.shade_hits(pack, static, old.org, old.dirn, hit, octx,
                                                 cam.light_bias)
        rad = old.radiance + old.throughput * em * old.alive[:, None]
        thr = old.throughput * torch.where(old.alive[:, None], wt, 0.0)
        alive_n = old.alive & ~ended
        old = tint.BounceState(torch.where(alive_n[:, None], pos, old.org),
                               torch.where(alive_n[:, None], nd, old.dirn), thr, rad, alive_n,
                               old.src, old.pixel, old.sample, depth + 1, old.seed)
        for f in ("org", "dirn", "throughput", "radiance", "alive", "src", "pixel", "sample"):
            assert torch.equal(torch.nan_to_num(getattr(s, f).double(), 7.0),
                               torch.nan_to_num(getattr(old, f).double(), 7.0)), (depth, f)


# ---------------------------------------------------------------- no fallback

def _failing_library():
    raise RuntimeError("the kernel library failed to load")


@pytest.mark.parametrize("which", vertex.KERNELS)
def test_loader_error_propagates(scenes, monkeypatch, which):
    pack, static, cam = scenes["mini_dragon"]
    pack = pack._replace()   # the tables it builds stay off the shared pack
    monkeypatch.setattr(_cuda, "_library", _failing_library)
    monkeypatch.setattr(vertex, "_bound", {})
    n = 64
    org, dirn = torch.zeros((n, 3)), torch.ones((n, 3))
    flag = torch.ones(n, dtype=torch.bool)
    i64 = torch.zeros(n, dtype=torch.int64)
    zero = torch.zeros((), dtype=torch.int64)
    before = dict(vertex.plain_calls)
    calls = {
        "vertex_hit": lambda: vertex.analytic_hits(pack, static, org, dirn, 1e-3, flag),
        "vertex_shade": lambda: vertex.shade_hits(
            pack, static, org, dirn, trng.Ctx(i64, i64, 0, 1), 0.25,
            (torch.zeros(n), i64.int(), torch.zeros(n), i64.int(), torch.zeros(n), i64.int())),
        "free_flight": lambda: vertex.free_flight(
            pack, static, org, dirn, trng.Ctx(i64, i64, 0, 1), 1e-3,
            (torch.zeros(n), i64.int(), torch.zeros(n), i64.int(), torch.zeros(n), i64.int())),
        "lane_update": lambda: vertex.lane_update(org, dirn, org, org, flag, org, org, org,
                                                  flag, org, bounce=i64, max_depth=4),
        "lane_bbox": lambda: vertex.lane_box(org),
        "compaction_key": lambda: vertex.compaction_key(org, dirn, flag),
        "pool_refill": lambda: vertex.pool_refill(
            i64, (org, dirn, org, org, i64, i64, i64, flag, flag), zero, zero, zero, zero,
            torch.zeros(vertex.CAMERA_FLOATS), 10, 0, 1, 4, 1, False, 0),
    }
    with pytest.raises(RuntimeError, match="failed to load"):
        calls[which]()
    assert vertex.plain_calls == before
    # the routed entry points take the kernel where the route says so
    monkeypatch.setattr(vertex, "use_kernels", lambda *a: True)
    with pytest.raises(RuntimeError, match="failed to load"):
        tint.shade_vertex(pack, static, org, dirn, trng.Ctx(i64, i64, 0, 1), 0.25, flag)


def test_route():
    cpu = torch.zeros((4, 3))
    pack, _ = tcompiler.compile_scene(models.build("test"), "cpu")
    assert not vertex.use_kernels(pack, cpu, cpu)
    with pytest.raises(ValueError, match="no path vertex kernels"):
        vertex.use_kernels(pack, torch.zeros((4, 3), device="meta"))


def test_tables_built_before_the_step(scenes, monkeypatch):
    pack, static, cam = scenes["mini_dragon"]
    pack = pack._replace()   # a pack object of its own: no tables kept yet
    monkeypatch.setattr(vertex, "use_kernels", lambda *a: True)
    built = []
    real = vertex.vertex_tables
    monkeypatch.setattr(vertex, "vertex_tables", lambda *a: built.append(1) or real(*a))
    n_pixels = cam.image_width * cam.image_height
    tpool.make_step(pack, static, cam, n_pixels, 1, 0, kernel="auto", graph=False)
    assert built == [1] and ("vertex", torch.device("cpu")) in cam._consts
    program = trend.BatchProgram(pack, static, cam, 64, 0, n_pixels, 1, "auto")
    assert program.pack is pack and built == [1]
    tb = vertex.tables(pack, static)
    assert built == [1] and tb.itab[vertex.H_NNODE] == len(static.tex_program)
    np.testing.assert_array_equal(vertex.camera_table(cam, "cpu").numpy(),
                                  vertex.camera_array(cam))
