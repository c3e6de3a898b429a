"""The path vertex as CUDA kernels: the port of XLA's fusion of the
reference's jitted step (its shading is elementwise work that
rust_raytracer_tpu leaves to XLA outside any Pallas kernel), with the scene
tables the kernels read.

  KV1 csrc/vertex_hit.cu     closest sphere hit (a walk of the spheres'
                             BVH) and plane hit, the triangle walk's
                             t_max (0 on a dead lane)
  KV-FF csrc/free_flight.cu  after the walk, in a scene with volumes only:
                             the merge of the three hits, then each
                             volume's free flight -> (t, kind, prim)
  KV2 csrc/vertex_shade.cu   after the walk: the merge with sun and sky,
                             the hit record, the texture program, the
                             7-way material, the normal map, the NEE
                             mixture; emission, weight, next direction,
                             ended, position
  KV3 csrc/lane_update.cu    the lane update after shading (pool and batch
                             forms), the origins' bounding box (lane_bbox)
                             and the int64 compaction key
  KV4 csrc/pool_refill.cu    after the sort: the permutation gather, the
                             radiance to retire, the refill with camera rays

The plain version of each is the torch-ops code it replaces, which stays
where it is: ops/intersect.py (intersect_spheres, intersect_planes,
_intersect, merge_volumes, hit_attributes), ops/texture.py, ops/shade.py,
ops/lights.py, render/integrator.py (shade_hits, _advance,
_compaction_key) and render/pool.py's step.  The callers there route each call (`use_kernels`):
CUDA tensors of a float32 pack with no input that requires grad take the
kernel; the CPU, a float64 pack on the card and a call under autograd with
grad-requiring inputs (the differentiable trace) take the plain version.
A kernel that fails to build or launch raises; nothing falls back.

`vertex_tables(pack, static)` packs the scene's static parts once into two
flat device tables, f32 and i32, that KV1, KV-FF and KV2 interpret: a
header of counts and offsets (csrc/vertex_common.cuh:Header), then the
sphere, plane, sun-direction, material, proxy-light, light, volume rows
(with each convex mesh boundary's triangles), the spheres' BVH that KV1
walks (`sphere_bvh`), the texture program's nodes
in topological order with their constants, the image and Perlin data at
offsets, and the closure table: for each shading key (each material, then
each sky and each sun, whose lanes also read material 0's roots) its
texture roots and the nodes they reach, in topological order, which is
all KV2 evaluates (`texture_closures`).  `tables` keeps them on the pack
object, built outside any capture (render/pool.py:make_step and
render/renderer.py:BatchProgram call `prepare`); `camera_table` does the
same for KV4's camera constants.  A closure of more than MAX_NODES nodes
raises ValueError when the tables are built; the program itself may be
of any length.

`launches[name]` counts each kernel's launches, `plain_calls[name]` calls
routed to its plain version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..scene import pack as sp
from . import _cuda
from . import intersect as isect
from . import texture as tex

KERNELS = ("vertex_hit", "vertex_shade", "lane_update", "lane_bbox", "compaction_key",
           "pool_refill", "free_flight")
launches = dict.fromkeys(KERNELS, 0)
plain_calls = dict.fromkeys(KERNELS, 0)

# the longest texture closure KV2 takes (the nodes one shading key's roots
# reach): the builtin scenes' whole programs (tonemap_test, 28 nodes)
# rounded up to a power of two
MAX_NODES = 32   # must match csrc/vertex_common.cuh:MAX_NODES

# csrc/vertex_common.cuh:Header (keep in step)
(H_NS, H_AFFINE, H_NP, H_NT, H_NVOL, H_NSKY, H_NSUN, H_NMAT, H_NLIGHT, H_NNODE, H_NPROXY,
 H_F_SPH, H_F_PLN, H_F_SUN, H_F_MAT, H_F_PROXY, H_F_CONST, H_F_NODE, H_F_BG,
 H_I_SPH, H_I_PLN, H_I_VOL, H_I_MAT, H_I_LIGHT, H_I_NODE, H_F_VOL, H_I_VOLK,
 H_I_CLOS, H_NBVH, H_F_BVH, H_I_BVH) = range(31)
HEADER = 32
# csrc/vertex_common.cuh:Rows
SPH_F, SPH_I, PLN_F, PLN_I, SUN_F, MAT_F, MAT_I = 22, 1, 19, 2, 3, 2, 1
LIGHT_I, PROXY_F, NODE_F, NODE_I, VOL_F, VOL_I = 2, 4, 1, 8, 16, 3
# a closure's row: (offset of its entries in itab, count, the positions of
# its albedo, roughness, normal-map and emission roots, -1 where it has
# none); an entry: (node, the positions of its children c0 c1 c2, 0 unused)
CLOS_I, CLOS_E = 6, 4
# csrc/pool_refill.cu:Cam
CAMERA_FLOATS = 20
# The spheres' BVH (csrc/vertex_common.cuh:SphereBvh, keep in step): a
# node's f32 row is its box lo, hi, the centre of the margin and the
# margin's two coefficients (BVH_F, a float4-aligned row); its i32 row the
# children (left, right), or (-1 - first, count) of a leaf, whose spheres'
# ids follow the node rows in leaf order (at most LEAF_SPHERES a leaf);
# BVH_STACK bounds the walk's depth.
BVH_F, BVH_I, LEAF_SPHERES, BVH_STACK = 12, 2, 4, 32
# The margin a lane widens a node's box by: MARGIN_EPS x (|o - ctr|^2 +
# R^2) x 2 / r, for a ray from o, the node's centre ctr, R the farthest
# sphere centre from it, r its spheres' least radius (affine: 1 /
# (|fwd| |inv|^2)).  A computed root lies within ~14 eps |o - c|^2 / r of
# its sphere (the discriminant's rounding, eps = 2^-24, near a tangent);
# MARGIN_EPS is ~4.5x that.  Each sphere's own box is widened besides by
# BOX_PAD of its largest coordinate and extent (16 ulps).
MARGIN_EPS, BOX_PAD = 2.0 ** -18, 2.0 ** -20

THREADS_KEY = 256   # csrc/lane_update.cu's block: one box a block
VOLUME_SLOTS = 32   # csrc/vertex_shade.cu:VOL_SLOTS, the slots of a counter row
# The rows of a pool step's counters, one (COUNTER_ROWS, VOLUME_SLOTS) int64
# buffer (`new_counters`): KV2's free-flight scattering events and sphere
# hits, each read as its row's sum, K1's leaf visits and groups tested in
# slots 0 and 1 of its row, and KV1's sphere-BVH node visits and sphere
# tests in slots 0 and 1 of its row.
ROW_VOLUME, ROW_SPHERE, ROW_K1, ROW_KV1 = 0, 1, 2, 3
COUNTER_ROWS = 4


class VertexTables(NamedTuple):
    ftab: torch.Tensor   # (F,) f32
    itab: torch.Tensor   # (I,) i32, the header first


class _TableRows:
    """Appends rows to the two tables and records their offsets."""

    def __init__(self):
        self.f, self.i = [], []
        self.nf, self.ni = 0, HEADER
        self.header = np.zeros(HEADER, np.int64)

    def floats(self, a, align: int = 1) -> int:
        a = np.asarray(a, np.float32).ravel()
        pad = -self.nf % align
        self.f.append(np.zeros(pad, np.float32))
        off = self.nf = self.nf + pad
        self.f.append(a)
        self.nf += a.size
        return off

    def ints(self, a, align: int = 1) -> int:
        a = np.asarray(a, np.int64).ravel()
        pad = -self.ni % align
        self.i.append(np.zeros(pad, np.int64))
        off = self.ni = self.ni + pad
        self.i.append(a)
        self.ni += a.size
        return off


def texture_closures(program, albedo, rough, normal, sky, sun) -> list:
    """(nodes, roots) of each shading key, in KV2's order of keys: each
    material m (roots albedo[m], rough[m], normal[m] or None, and no
    emission), then each sky s and each sun u (material 0's three roots,
    since such a lane's material id is 0, and the emission root sky[s] or
    sun[u]).  `nodes` are the ids that the roots reach through the
    children, ascending: a topological order, as the program's own.  An
    empty program has empty closures (KV2 then reads zeros, as
    ops/texture.py:eval_program gives)."""
    def reach(roots):
        seen, todo = set(), [r for r in roots if r is not None and 0 <= r < len(program)]
        while todo:
            k = todo.pop()
            if k not in seen:
                seen.add(k)
                todo.extend(program[k].children)
        return sorted(seen)

    def mat_roots(m):
        return (int(albedo[m]), int(rough[m]), int(normal[m]) if normal[m] >= 0 else None)

    keys = [(*mat_roots(m), None) for m in range(len(albedo))]
    base = mat_roots(0) if len(albedo) else (0, 0, None)
    keys += [(*base, int(e)) for e in list(sky) + list(sun)]
    return [(reach(roots), roots) for roots in keys]


def sphere_bvh(center, radius, inv=None, fwd=None):
    """The spheres' BVH that KV1 walks, built from the float32 rows it
    tests: (node_f (n, BVH_F) f32, node_i (n, BVH_I) int64, leaf ids (ns,)
    int64), node 0 the root and the nodes in pre-order.  A node splits its
    spheres at the median of their centres along the longest axis of the
    centres' box (a stable sort) until a leaf holds at most LEAF_SPHERES;
    at most that many spheres make one leaf, the loop over them all.  A
    node's box holds its spheres' boxes, centre +- |radius| (an affine
    sphere, `inv` and `fwd` given: +- the row norms of `fwd`), each
    widened by BOX_PAD of its largest coordinate and extent, rounded
    outward to f32; its margin coefficients (MARGIN_EPS) are rounded up.
    Raises ValueError for a tree deeper than BVH_STACK."""
    c = np.asarray(center, np.float64).reshape(-1, 3)
    ns = c.shape[0]
    if fwd is not None:
        fwd, inv = np.asarray(fwd, np.float64), np.asarray(inv, np.float64)
        ext = np.linalg.norm(fwd, axis=2)
        r_eff = 1.0 / (np.linalg.norm(fwd, 2, axis=(1, 2))
                       * np.linalg.norm(inv, 2, axis=(1, 2)) ** 2)
    else:
        r_eff = np.abs(np.asarray(radius, np.float64))
        ext = np.repeat(r_eff[:, None], 3, axis=1)
    pad = BOX_PAD * (np.abs(c).max(axis=1, initial=0.0) + ext.max(axis=1, initial=0.0))
    box_lo, box_hi = c - ext - pad[:, None], c + ext + pad[:, None]
    node_f, node_i, leaf = [], [], []

    def down(x):
        x32 = np.float32(x)
        return np.where(x32 > x, np.nextafter(x32, np.float32(-np.inf)), x32)

    def up(x):
        x32 = np.float32(np.minimum(x, np.finfo(np.float32).max))
        return np.where(x32 < x, np.nextafter(x32, np.float32(np.inf)), x32)

    def build(ids, depth):
        if depth > BVH_STACK:
            raise ValueError(f"a sphere BVH deeper than {BVH_STACK} levels (ops/vertex.py:"
                             f"BVH_STACK)")
        k = len(node_f)
        lo, hi = down(box_lo[ids].min(axis=0)), up(box_hi[ids].max(axis=0))
        ctr = np.float32((lo.astype(np.float64) + hi) / 2)
        far = np.linalg.norm(c[ids] - ctr, axis=1).max()
        beta = 2.0 * MARGIN_EPS / max(r_eff[ids].min(), 1e-30)
        row = np.zeros(BVH_F, np.float32)
        row[0:3], row[3:6], row[6:9] = lo, hi, ctr
        row[9], row[10] = up(beta), up(beta * far * far)
        node_f.append(row)
        node_i.append([0, 0])
        if len(ids) <= LEAF_SPHERES:
            node_i[k] = [-1 - len(leaf), len(ids)]
            leaf.extend(ids)
            return k
        span = c[ids].max(axis=0) - c[ids].min(axis=0)
        order = ids[np.argsort(c[ids, int(np.argmax(span))], kind="stable")]
        mid = len(ids) // 2
        node_i[k] = [build(order[:mid], depth + 1), build(order[mid:], depth + 1)]
        return k

    if ns:
        build(np.arange(ns), 1)
    return (np.asarray(node_f, np.float32).reshape(-1, BVH_F),
            np.asarray(node_i, np.int64).reshape(-1, BVH_I), np.asarray(leaf, np.int64))


def table_arrays(pack, static):
    """The tables as numpy arrays (f32, i32): see the module docstring and
    csrc/vertex_common.cuh.  Raises ValueError for a texture closure of
    more than MAX_NODES nodes or a node kind the kernel does not know."""
    program = static.tex_program

    def host(t):
        return t.detach().cpu().numpy()

    b = _TableRows()
    h = b.header
    ns = pack.sph_center.shape[0]
    affine = pack.sph_inv.shape[0] > 0
    sph = np.zeros((ns, SPH_F), np.float32)
    if ns:
        sph[:, 0:3] = host(pack.sph_center)
        sph[:, 3] = host(pack.sph_radius)
        if affine:
            sph[:, 4:13] = host(pack.sph_inv).reshape(ns, 9)
            sph[:, 13:22] = host(pack.sph_fwd).reshape(ns, 9)
    h[H_NS], h[H_AFFINE] = ns, int(affine)
    h[H_F_SPH], h[H_I_SPH] = b.floats(sph), b.ints(host(pack.sph_mat))
    mats = (sph[:, 4:13].reshape(ns, 3, 3), sph[:, 13:22].reshape(ns, 3, 3)) if affine else ()
    node_f, node_i, leaf = sphere_bvh(sph[:, 0:3], sph[:, 3], *mats)
    h[H_NBVH] = node_f.shape[0]
    h[H_F_BVH] = b.floats(node_f, align=4)
    h[H_I_BVH] = b.ints(np.concatenate([node_i.ravel(), leaf]), align=2)

    npl = pack.pln_corner.shape[0]
    pln = np.zeros((npl, PLN_F), np.float32)
    for k, f in enumerate(("pln_corner", "pln_uhalf", "pln_vhalf", "pln_dual_u",
                           "pln_dual_v", "pln_normal")):
        pln[:, 3 * k:3 * k + 3] = host(getattr(pack, f)).reshape(npl, 3)
    pln[:, 18] = host(pack.pln_area)
    h[H_NP] = npl
    h[H_F_PLN] = b.floats(pln)
    h[H_I_PLN] = b.ints(np.stack([host(pack.pln_backface).astype(np.int64),
                                  host(pack.pln_mat)], axis=1))

    h[H_NT] = pack.tri_attr.shape[0]
    nv = h[H_NVOL] = pack.vol_kind.shape[0]
    h[H_I_VOL] = b.ints(host(pack.vol_mat))
    vol = np.zeros((nv, VOL_F), np.float32)
    vol_i = np.zeros((nv, VOL_I), np.int64)
    if nv:
        vol[:, 0:3] = host(pack.vol_center)
        vol[:, 3:12] = host(pack.vol_axes).reshape(nv, 9)
        vol[:, 12:15] = host(pack.vol_halfsize)
        vol[:, 15] = host(pack.vol_neg_inv_density)
    for vi, (kind, count) in enumerate(zip(pack.vol_kinds, pack.vol_tri_counts)):
        vol_i[vi, 0] = kind
        if kind == sp.VOL_MESH:
            block = np.concatenate([host(getattr(pack, f)[vi, :count])
                                    for f in ("vol_tri_v0", "vol_tri_e1", "vol_tri_e2")], axis=1)
            vol_i[vi, 1], vol_i[vi, 2] = b.floats(block), count
    h[H_F_VOL], h[H_I_VOLK] = b.floats(vol), b.ints(vol_i)
    h[H_NSKY] = pack.sky_tex.shape[0]
    h[H_NSUN] = pack.sun_dir.shape[0]
    h[H_F_SUN] = b.floats(host(pack.sun_dir))

    h[H_NMAT] = pack.mat_type.shape[0]
    h[H_F_MAT] = b.floats(np.stack([host(pack.mat_inv_ior), host(pack.mat_ior)], axis=1))
    h[H_I_MAT] = b.ints(host(pack.mat_type))

    h[H_NLIGHT] = len(static.light_list)
    h[H_I_LIGHT] = b.ints(np.asarray(static.light_list, np.int64).reshape(-1, LIGHT_I))
    h[H_NPROXY] = pack.lgt_sph_center.shape[0]
    h[H_F_PROXY] = b.floats(np.concatenate([host(pack.lgt_sph_center).reshape(-1, 3),
                                            host(pack.lgt_sph_radius).reshape(-1, 1)], axis=1))
    h[H_F_BG] = b.floats(host(pack.background))

    h[H_NNODE] = len(program)
    const = host(pack.tex_const).reshape(-1, 3)
    h[H_F_CONST] = b.floats(const[:len(program)] if len(program) else np.zeros((0, 3)))
    data = [host(d) for d in pack.tex_data]
    node_f = np.zeros((len(program), NODE_F), np.float32)
    node_i = np.zeros((len(program), NODE_I), np.int64)
    for k, node in enumerate(program):
        row = node_i[k]
        row[0] = node.kind
        node_f[k, 0] = node.scale
        row[1:1 + len(node.children)] = node.children
        if node.kind == tex.IMAGE:
            px = data[node.data_idx]
            row[4] = b.floats(px)
            row[5], row[6] = px.shape[0], px.shape[1]
            row[7] = int(node.repeat == tex.CLAMP)
        elif node.kind == tex.NOISE_SOLID:
            grad, perm_x, perm_y, perm_z = data[node.data_idx:node.data_idx + 4]
            row[4] = b.floats(grad)
            row[5] = b.ints(np.concatenate([perm_x, perm_y, perm_z]))
            row[6] = node.samples
            row[7] = 0 if node.noise_map == "marble" else 1
        elif node.kind == tex.CHANNEL:
            row[4] = node.channel
        elif node.kind not in (tex.CONSTANT, tex.CHECKER, tex.CHECKER_SOLID, tex.LERP,
                               tex.UV_DEBUG):
            raise ValueError(f"unknown texture node kind {node.kind}")
    h[H_F_NODE] = b.floats(node_f)
    h[H_I_NODE] = b.ints(node_i)

    closures = texture_closures(program, host(pack.mat_albedo_tex), host(pack.mat_rough_tex),
                                host(pack.mat_normal_tex), host(pack.sky_tex),
                                host(pack.sun_tex))
    rows = np.zeros((len(closures), CLOS_I), np.int64)
    for key, (nodes, roots) in enumerate(closures):
        if len(nodes) > MAX_NODES:
            raise ValueError(f"a texture closure of {len(nodes)} nodes (shading key {key}): "
                             f"the shading kernel takes at most {MAX_NODES} "
                             f"(ops/vertex.py:MAX_NODES)")
        at = {k: p for p, k in enumerate(nodes)}
        entries = np.zeros((len(nodes), CLOS_E), np.int64)
        for p, k in enumerate(nodes):
            entries[p, 0] = k
            entries[p, 1:1 + len(program[k].children)] = [at[c] for c in program[k].children]
        rows[key, 0], rows[key, 1] = b.ints(entries), len(nodes)
        rows[key, 2:] = [-1 if r is None else at.get(r, 0) for r in roots]
    h[H_I_CLOS] = b.ints(rows)

    ftab = np.concatenate(b.f) if b.f else np.zeros(0, np.float32)
    itab = np.concatenate([h] + b.i)
    if np.abs(itab).max(initial=0) >= 2**31 or ftab.size >= 2**31:
        raise ValueError("the vertex tables outgrow int32 offsets")
    return np.ascontiguousarray(ftab, np.float32), itab.astype(np.int32)


def vertex_tables(pack, static) -> VertexTables:
    """The tables of (pack, static) on the pack's device (one host copy
    each: build them outside any capture)."""
    f, i = table_arrays(pack, static)
    dev = pack.device
    return VertexTables(torch.from_numpy(f).to(dev), torch.from_numpy(i).to(dev))


def tables(pack, static) -> VertexTables:
    """vertex_tables(pack, static), built once and kept on the pack object
    (a graph that reads them holds the pack, and so them)."""
    kept = pack.__dict__.setdefault("_vertex_tables", {})
    entry = kept.get(id(static))
    if entry is None or entry[0] is not static:
        entry = kept[id(static)] = (static, vertex_tables(pack, static))
    return entry[1]


def camera_array(camera) -> np.ndarray:
    """KV4's camera constants (csrc/pool_refill.cu:Cam) as f32, rounded
    from the camera's float64 geometry as generate_rays rounds them."""
    out = np.zeros(CAMERA_FLOATS, np.float64)
    for k, v in enumerate((camera.position, camera.first_pixel, camera.pixel_delta_u,
                           camera.pixel_delta_v, camera.basis[0], camera.basis[1])):
        out[3 * k:3 * k + 3] = np.asarray(v, np.float64)
    out[18] = camera.aperture_radius or 0.0
    out[19] = 1.0 / camera.sqrt_spt
    return out.astype(np.float32)


def camera_table(camera, device) -> torch.Tensor:
    """camera_array on `device`, built once a device (kept in the camera's
    constants, as generate_rays keeps its own)."""
    key = ("vertex", torch.device(device))
    if key not in camera._consts:
        camera._consts[key] = torch.from_numpy(camera_array(camera)).to(device)
    return camera._consts[key]


def use_kernels(pack, *tensors) -> bool:
    """The route of a vertex call: True (the kernels) for CUDA tensors of a
    float32 pack (or of no pack: the key) when no input requires grad under
    autograd; False (the plain versions) on the CPU, for a float64 pack or
    tensor, and for the differentiable trace's grad-requiring inputs."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no path vertex kernels for device {dev}")
    if (pack is not None and pack.dtype != torch.float32) or any(
            t.dtype == torch.float64 for t in tensors):
        return False
    if torch.is_grad_enabled() and (
            any(t.requires_grad for t in tensors)
            or (pack is not None
                and any(getattr(pack, f).requires_grad for f in pack.float_fields()))):
        return False
    return True


def prepare(pack, static, camera=None) -> None:
    """Build the tables (and the camera's) that the kernels of this pack
    read, if its calls take the kernels: before a capture, so that no step
    copies from the host."""
    if use_kernels(pack, pack.background):
        tables(pack, static)
        if camera is not None:
            camera_table(camera, pack.device)


# ---------------------------------------------------------------- launches

_bound = {}


def _launch(name: str, ptrs, ints=(), floats=(), device=None) -> None:
    """C function `name` (pointers, int64s, floats, stream) on the current
    stream of `device`, with it current; raise if the launch failed."""
    fn = _bound.get(name)
    if fn is None:
        fn = _bound[name] = _cuda.c_function(
            name, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_longlong] * len(ints)
            + [ctypes.c_float] * len(floats) + [ctypes.c_void_p])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(None if p is None else p.data_ptr() for p in ptrs), *ints, *floats, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")


def _check(dev, *pairs):
    """Each (tensor, dtype, shape or None) on `dev`, contiguous, of that
    dtype and shape."""
    for t, dtype, shape in pairs:
        if t is None:
            continue
        if t.device != dev or not t.is_contiguous() or t.dtype != dtype or (
                shape is not None and tuple(t.shape) != tuple(shape)):
            raise ValueError(f"a vertex kernel takes contiguous {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _key_value(x, n):
    """(pointer tensor, stride, value) of an RNG key field: an (n,) or 0-d
    int64 tensor, or an int."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int64:
            x = x.to(torch.int64)
        x = x.contiguous()
        return x, (1 if x.dim() and x.shape[0] == n and n > 1 else 0), 0
    return None, 0, int(x) & 0xFFFFFFFF


def analytic_hits(pack, static, org, dirn, t_min: float, alive=None, counts=None):
    """KV1: (t_sph, i_sph, t_pln, i_pln, tri_tmax) of (n, 3) f32 rays on the
    card, the plain version's first lines of ops/intersect.py:_intersect.
    With `counts` ((2,) int64), the kernel adds the sphere-BVH nodes its
    lanes (those of `alive`, or all) visited and the spheres they tested
    to its slots 0 and 1, one atomic a warp each."""
    n, dev = org.shape[0], org.device
    tb = tables(pack, static)
    _check(dev, (org, torch.float32, (n, 3)), (dirn, torch.float32, (n, 3)),
           (alive, torch.bool, (n,)), (counts, torch.int64, (2,)))
    f32, i32 = torch.float32, torch.int32
    out = (torch.empty(n, dtype=f32, device=dev), torch.empty(n, dtype=i32, device=dev),
           torch.empty(n, dtype=f32, device=dev), torch.empty(n, dtype=i32, device=dev),
           torch.empty(n, dtype=f32, device=dev))
    if n:
        _launch("rrt_vertex_hit", (tb.ftab, tb.itab, org, dirn, alive, counts, *out), (n,),
                (t_min,), dev)
        launches["vertex_hit"] += 1
    return out


def _key_fields(ctx, n, who):
    """(pixel, sample, bounce, bounce stride, bounce value, seed, seed value)
    of the RNG key `ctx` for a kernel of `n` lanes: (n,) pixel and sample
    ids, one bounce or one a lane, one seed; raise otherwise."""
    pixel, _, _ = _key_value(ctx.pixel, n)
    sample, _, _ = _key_value(ctx.sample, n)
    if pixel is None or sample is None or pixel.shape != (n,) or sample.shape != (n,):
        raise ValueError(f"the {who} kernel takes (n,) pixel and sample ids")
    bounce, b_stride, b_val = _key_value(ctx.bounce, n)
    seed, _, s_val = _key_value(ctx.seed, n)
    if seed is not None and seed.numel() != 1:
        raise ValueError(f"the {who} kernel takes one seed")
    if bounce is not None and bounce.numel() not in (1, n):
        raise ValueError(f"the {who} kernel takes one bounce or one a lane")
    return pixel, sample, bounce, b_stride, b_val, seed, s_val


def free_flight(pack, static, org, dirn, ctx, t_min: float, hits):
    """KV-FF: (t, kind, prim) on the card, as ops/intersect.py:merge_volumes
    returns them.  `hits` is (t_sph, i_sph, t_pln, i_pln, t_tri, i_tri), the
    (n,) f32 / i32 hits of KV1 and the walk; `ctx` the lanes' RNG key (as
    shade_hits takes it); `t_min` the T_MIN of the lanes."""
    n, dev = org.shape[0], org.device
    tb = tables(pack, static)
    f32, i32 = torch.float32, torch.int32
    if len(hits) != 6:
        raise ValueError("the free-flight kernel takes six hit fields")
    _check(dev, (org, f32, (n, 3)), (dirn, f32, (n, 3)),
           *((x, f32 if k % 2 == 0 else i32, (n,)) for k, x in enumerate(hits)))
    pixel, sample, bounce, b_stride, b_val, seed, s_val = _key_fields(ctx, n, "free-flight")
    _check(dev, *((x, torch.int64, None) for x in (pixel, sample, bounce, seed)))
    out = (torch.empty(n, dtype=f32, device=dev), torch.empty(n, dtype=i32, device=dev),
           torch.empty(n, dtype=i32, device=dev))
    if n:
        _launch("rrt_free_flight", (tb.ftab, tb.itab, org, dirn, *hits, pixel, sample, bounce,
                                    seed, *out), (n, b_stride, b_val, s_val), (t_min,), dev)
        launches["free_flight"] += 1
    return out


def shade_hits(pack, static, org, dirn, ctx, light_bias: float, hits, merged=None,
               alive=None, volume_hits=None, sphere_hits=None):
    """KV2: (emission, weight, new_dir, ended, pos) on the card.  `hits` is
    (t_sph, i_sph, t_pln, i_pln, t_tri, i_tri); or, with `merged` =
    (t, kind, prim), the merged hit after the volumes (`hits` unused).
    With `merged` and `volume_hits` ((VOLUME_SLOTS,) int64, read as its
    sum), the kernel adds to it the lanes (of `alive`, or all) whose hit is
    a volume's scattering event; with `sphere_hits` (the same form), the
    lanes whose closest hit is a sphere."""
    n, dev = org.shape[0], org.device
    tb = tables(pack, static)
    f32 = torch.float32
    if merged is not None:
        t, kind, prim = merged
        ins = (t, prim, None, None, None, None, kind)
    else:
        ts, i_s, tp, ip, tt, it = hits
        ins = (ts, i_s, tp, ip, tt, it, None)
    _check(dev, (org, f32, (n, 3)), (dirn, f32, (n, 3)), (pack.tri_attr, f32, None),
           *((x, f32 if k in (0, 2, 4) else torch.int32, (n,)) for k, x in enumerate(ins)))
    pixel, sample, bounce, b_stride, b_val, seed, s_val = _key_fields(ctx, n, "shading")
    _check(dev, *((x, torch.int64, None) for x in (pixel, sample, bounce, seed)))
    alive = alive if volume_hits is not None or sphere_hits is not None else None
    _check(dev, (alive, torch.bool, (n,)), (volume_hits, torch.int64, (VOLUME_SLOTS,)),
           (sphere_hits, torch.int64, (VOLUME_SLOTS,)))
    out = (torch.empty((n, 3), dtype=f32, device=dev), torch.empty((n, 3), dtype=f32, device=dev),
           torch.empty((n, 3), dtype=f32, device=dev), torch.empty(n, dtype=torch.bool, device=dev),
           torch.empty((n, 3), dtype=f32, device=dev))
    if n:
        emission, weight, new_dir, ended, pos = out
        _launch("rrt_vertex_shade",
                (tb.ftab, tb.itab, pack.tri_attr, org, dirn, *ins, pixel, sample, bounce, seed,
                 alive, volume_hits, sphere_hits, emission, weight, new_dir, ended, pos),
                (n, int(merged is not None), b_stride, b_val, s_val),
                (light_bias, 1.0 - light_bias), dev)
        launches["vertex_shade"] += 1
    return out


def lane_update(org, dirn, throughput, radiance, active, emission, weight, new_dir, ended,
                pos, bounce=None, max_depth: int = 0):
    """KV3's update on the card.  With `bounce` (the pool): returns (org,
    dirn, throughput, radiance, bounce, still, retired, n_dead), n_dead a
    (1,) int64 count of the lanes not still (what pool_refill reads);
    without (the batch bounce): (org, dirn, throughput, radiance, alive)."""
    n, dev = org.shape[0], org.device
    f32 = torch.float32
    _check(dev, *((x, f32, (n, 3)) for x in (org, dirn, throughput, radiance, emission, weight,
                                              new_dir, pos)),
           (active, torch.bool, (n,)), (ended, torch.bool, (n,)), (bounce, torch.int64, (n,)))
    out = [torch.empty((n, 3), dtype=f32, device=dev) for _ in range(4)]
    still = torch.empty(n, dtype=torch.bool, device=dev)
    if bounce is None:
        b_out = retired = n_dead = None
    else:
        b_out = torch.empty(n, dtype=torch.int64, device=dev)
        retired = torch.empty(n, dtype=torch.bool, device=dev)
        n_dead = torch.zeros(1, dtype=torch.int64, device=dev)
    if n:
        _launch("rrt_lane_update",
                (org, dirn, throughput, radiance, bounce, active, emission, weight, new_dir,
                 ended, pos, *out, b_out, still, retired, n_dead),
                (n, max_depth), (), dev)
        launches["lane_update"] += 1
    if bounce is None:
        return (*out, still)
    return (*out, b_out, still, retired, n_dead)


def lane_box(org):
    """KV3's box on the card: (6,) f32, the lo then hi of `org` (n, 3)
    over its lanes, as org.amin(0), org.amax(0)."""
    n, dev = org.shape[0], org.device
    _check(dev, (org, torch.float32, (n, 3)))
    blocks = max(1, (n + THREADS_KEY - 1) // THREADS_KEY)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    partial = torch.empty(blocks * 6, dtype=torch.float32, device=dev)
    box = torch.empty(6, dtype=torch.float32, device=dev)
    _launch("rrt_lane_bbox", (org, counter, partial, box), (n,), (), dev)
    launches["lane_bbox"] += 1
    return box


def compaction_key(org, dirn, alive, box=None):
    """KV3's key on the card: render/integrator.py:_compaction_key
    (dir_bits 3) of the lanes, from `box` (lane_box's), or from lane_box
    of `org` launched first."""
    n, dev = org.shape[0], org.device
    _check(dev, (org, torch.float32, (n, 3)), (dirn, torch.float32, (n, 3)),
           (alive, torch.bool, (n,)), (box, torch.float32, (6,)))
    key = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        if box is None:
            box = lane_box(org)
        _launch("rrt_compaction_key", (org, dirn, alive, box, key), (n,), (), dev)
        launches["compaction_key"] += 1
    return key


def pool_refill(perm, lanes, n_dead, next_flat, overflow, wf_overflow, cam, quota: int,
                job_base: int, spp: int, width: int, sqrt_spt: int, has_aperture: bool, seed):
    """KV4 on the card.  `lanes` = (org, dirn, throughput, radiance, pixel,
    sample, bounce, still, retired) as lane_update returned them (unsorted),
    `perm` the stable sort's permutation of their key, `n_dead`
    lane_update's count of dead lanes.  Returns (org, dirn, throughput,
    radiance, pixel, sample, bounce, active, ret_pixel, contrib, next_flat,
    overflow): the next lane fields, the pixel and radiance of each sorted
    lane for the image's index_add (0 where it did not retire), and the 0-d
    counters."""
    org = lanes[0]
    n, dev = org.shape[0], org.device
    f32, i64 = torch.float32, torch.int64
    _check(dev, (perm, i64, (n,)), *((x, f32, (n, 3)) for x in lanes[:4]),
           *((x, i64, (n,)) for x in lanes[4:7]), *((x, torch.bool, (n,)) for x in lanes[7:]),
           (next_flat, i64, ()), (overflow, i64, ()), (wf_overflow, i64, ()),
           (cam, f32, (CAMERA_FLOATS,)))
    out = ([torch.empty((n, 3), dtype=f32, device=dev) for _ in range(4)]
           + [torch.empty(n, dtype=i64, device=dev) for _ in range(3)]
           + [torch.empty(n, dtype=torch.bool, device=dev), torch.empty(n, dtype=i64, device=dev),
              torch.empty((n, 3), dtype=f32, device=dev), torch.empty((), dtype=i64, device=dev),
              torch.empty((), dtype=i64, device=dev)])
    _launch("rrt_pool_refill",
            (perm, *lanes, n_dead, next_flat, overflow, wf_overflow, cam, *out),
            (n, quota, job_base, spp, width, sqrt_spt, int(has_aperture), int(seed) & 0xFFFFFFFF),
            (), dev)
    launches["pool_refill"] += 1
    return tuple(out)


def attributes():
    """Registers, local bytes and static shared bytes of each kernel
    (cudaFuncGetAttributes), by name."""
    return {name: _cuda.attributes("rrt_" + name) for name in KERNELS}


def new_counters(device=None) -> torch.Tensor:
    """A pool step's counters, zeroed: (COUNTER_ROWS, VOLUME_SLOTS) int64
    on `device`, a row each (ROW_VOLUME, ROW_SPHERE, ROW_K1, ROW_KV1)."""
    return torch.zeros((COUNTER_ROWS, VOLUME_SLOTS), dtype=torch.int64, device=device)


COUNTER_NAMES = ("volume_hits", "sphere_hits", "k1_leaf_visits", "k1_groups_tested",
                 "kv1_node_visits", "kv1_sphere_tests")


def counter_values(counters) -> dict:
    """{COUNTER_NAMES} of one or more `new_counters` buffers (summed), host
    ints: one read each."""
    total = [0] * len(COUNTER_NAMES)
    for c in counters:
        rows = c.tolist()
        for k, v in enumerate((sum(rows[ROW_VOLUME]), sum(rows[ROW_SPHERE]),
                               rows[ROW_K1][0], rows[ROW_K1][1],
                               rows[ROW_KV1][0], rows[ROW_KV1][1])):
            total[k] += v
    return dict(zip(COUNTER_NAMES, total))


def fused_vertex(pack, static, org, dirn, ctx, light_bias, alive, kernel, t_min,
                 counters=None):
    """KV1 -> the triangle walk -> (in a scene with volumes KV-FF) -> KV2: a
    path vertex on the card, as render/integrator.py:shade_vertex returns
    it: (emission, weight, new_dir, ended, pos, stats).  With `counters`
    (`new_counters`), KV2 adds the `alive` lanes' scattering events (in a
    scene with volumes) and the `alive` lanes whose closest hit is a sphere
    (in a scene with spheres) to their rows, one atomic a warp each, the
    BVH8 walk its leaf visits and groups tested to its row, and KV1 (in a
    scene with spheres) the `alive` lanes' sphere-BVH node visits and
    sphere tests to its row."""
    org, dirn = org.contiguous(), dirn.contiguous()
    volume_hits = sphere_hits = k1_counts = kv1_counts = None
    if counters is not None:
        volume_hits = counters[ROW_VOLUME] if pack.vol_kinds else None
        if pack.sph_center.shape[0]:
            sphere_hits, kv1_counts = counters[ROW_SPHERE], counters[ROW_KV1, :2]
        k1_counts = counters[ROW_K1, :2]
    with torch.no_grad():
        t_sph, i_sph, t_pln, i_pln, tri_tmax = analytic_hits(pack, static, org, dirn, t_min,
                                                             alive, kv1_counts)
        t_tri, i_tri, stats = isect.intersect_triangles(pack, org, dirn, t_min, tri_tmax,
                                                        kernel=kernel, return_stats=True,
                                                        k1_counts=k1_counts)
        hits = (t_sph, i_sph, t_pln, i_pln, t_tri.contiguous(), i_tri.contiguous())
        merged = free_flight(pack, static, org, dirn, ctx, t_min, hits) if pack.vol_kinds else None
        return (*shade_hits(pack, static, org, dirn, ctx, light_bias, hits, merged, alive,
                            volume_hits=volume_hits, sphere_hits=sphere_hits), stats)

