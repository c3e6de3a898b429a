"""The port's native C++ core (rust_raytracer_torch/native) and its NumPy
fallbacks, as tests/test_native.py holds the JAX package's: the native
BVH's layout invariants, the RRT_NO_NATIVE switch, the Morton fallback
(scene/bvh_builder.py) leaf for leaf against the JAX package's fallback,
and the NumPy OBJ parser (utils/assets.py) against the native one.  Every
test starts and ends with both packages' native state reset, so the
switch is read afresh."""
import numpy as np
import pytest

from rust_raytracer_tpu import native as jnative
from rust_raytracer_tpu.scene import bvh_builder as jbvh
from rust_raytracer_torch import native as tnative
from rust_raytracer_torch.scene import bvh_builder as tbvh
from rust_raytracer_torch.utils import assets as tassets

N_BOXES = 5000


def _reset():
    for mod in (tnative, jnative):
        mod._lib = None
        mod._lib_failed = False


@pytest.fixture
def fresh_native(monkeypatch):
    """Both packages' native libraries unloaded, RRT_NO_NATIVE unset; reset
    again afterwards."""
    monkeypatch.delenv("RRT_NO_NATIVE", raising=False)
    _reset()
    yield monkeypatch
    _reset()


@pytest.fixture
def native_off(fresh_native):
    fresh_native.setenv("RRT_NO_NATIVE", "1")
    return fresh_native


def boxes(n=N_BOXES, seed=1):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.3, (n, 3)).astype(np.float32)
    return c - h, c + h


def check_layout(flat, lo, hi):
    """tests/test_native.py's invariants: every primitive once, links in
    range and forward, leaf boxes holding their primitives, and the hit
    links visiting every node once."""
    n, m = lo.shape[0], flat.node_min.shape[0]
    used = flat.tri_order[flat.tri_order >= 0]
    assert sorted(used.tolist()) == list(range(n))
    idx = np.arange(m)
    assert (flat.hit_link > idx).all() and (flat.hit_link <= m).all()
    assert (flat.miss_link > idx).all() and (flat.miss_link <= m).all()
    for li in np.where(flat.leaf_start >= 0)[0][:500]:
        s = flat.leaf_start[li]
        tris = flat.tri_order[s:s + tbvh.LEAF_SIZE]
        tris = tris[tris >= 0]
        assert (lo[tris] >= flat.node_min[li] - 1e-4).all()
        assert (hi[tris] <= flat.node_max[li] + 1e-4).all()
    seen = np.zeros(m, bool)
    node = steps = 0
    while node < m and steps <= m:
        seen[node] = True
        node = int(flat.hit_link[node])
        steps += 1
    assert seen.all() and steps == m


def test_native_bvh_layout_invariants(fresh_native):
    """The native binned-SAH build of 5,000 random boxes keeps the threaded
    layout's invariants."""
    if not tnative.available():
        pytest.skip("native toolchain (g++) unavailable")
    lo, hi = boxes()
    check_layout(tbvh.build(lo, hi), lo, hi)


def test_no_native_switch(native_off):
    """RRT_NO_NATIVE turns the native library off when it is first asked
    for, as the reference's switch does, and the fallback build keeps the
    layout's invariants."""
    assert not tnative.available()
    assert tnative.build_bvh(*boxes(100), tbvh.LEAF_SIZE) is None
    lo, hi = boxes()
    check_layout(tbvh.build(lo, hi), lo, hi)


def test_morton_fallback_matches_jax(native_off):
    """With native off in both packages, the port's Morton fallback builds
    the JAX package's FlatBVH from the same 5,000 boxes, array for array."""
    assert not jnative.available() and not tnative.available()
    lo, hi = boxes()
    got, want = tbvh.build(lo, hi), jbvh.build(lo, hi)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


OBJ = """# a quad, a triangle without uvs, a fan, and negative indices
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1.25
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0 2
f 1/1/1 2/2/1 3/3/1 4/4/1
f 1//2 2//2 5//2
f 2 3 5
f -5/-4/-2 -4/-3/-2 -1/-1/-1
"""


def test_obj_numpy_parser_matches_native(fresh_native, tmp_path):
    """The NumPy OBJ parser gives the native parser's arrays on a small OBJ
    (a quad, a triangle without uvs, one without normals, negative
    indices): triangles and vertices exactly, normals within 1e-12."""
    path = tmp_path / "small.obj"
    path.write_text(OBJ)
    if not tnative.available():
        pytest.skip("native toolchain (g++) unavailable")
    native = tassets.parse_obj(str(path))
    _reset()
    fresh_native.setenv("RRT_NO_NATIVE", "1")
    fallback = tassets.parse_obj(str(path))
    assert not tnative.available()
    v1, uv1, n1, t1 = native
    v2, uv2, n2, t2 = fallback
    assert t1.shape == (5, 3, 3)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(uv1, uv2)
    np.testing.assert_allclose(n1, n2, rtol=1e-12, atol=1e-12)
