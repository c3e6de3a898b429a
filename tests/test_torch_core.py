"""Port core (rust_raytracer_torch/core) against the JAX package's core:
pcg4d bit for bit, the Box-Muller draws and every vector-math helper at
rtol 1e-6 (atol 1e-6 for values near zero, where a relative bound means
nothing)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytracer_tpu.core import math as jmath
from rust_raytracer_tpu.core import rng as jrng
from rust_raytracer_torch.core import math as tmath
from rust_raytracer_torch.core import rng as trng

torch.set_num_threads(2)

EDGES = np.array([0, 2**31, 2**32 - 1, 2**32 - 128], np.int64)


@pytest.fixture(scope="module")
def keys():
    q = np.random.default_rng(0).integers(0, 2**32, size=(4, 4096), dtype=np.int64)
    # every edge value in every key position
    edge = np.array(np.meshgrid(EDGES, EDGES, EDGES, EDGES)).reshape(4, -1)
    return np.concatenate([q, edge], axis=1)


def _jax_u32(a):
    return jnp.asarray(a.astype(np.uint32))


def test_pcg4d_bits_equal(keys):
    want = jrng.random_bits4(*(_jax_u32(k) for k in keys))
    got = trng.random_bits4(*(torch.from_numpy(k) for k in keys))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_uniform4_equal(keys):
    want = jrng.uniform4(*(_jax_u32(k) for k in keys))
    got = trng.uniform4(*(torch.from_numpy(k) for k in keys))
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_uniform_rounds_top_draws_to_one():
    """The u32 -> f32 rounding of rng.py:63: 2^32 - 128 and above draw 1.0."""
    v = torch.tensor([2**32 - 128, 2**32 - 129, 2**32 - 1], dtype=torch.int64)
    top, below, last = trng._to_unit(v).tolist()
    assert top == 1.0 and last == 1.0 and below < 1.0


@pytest.mark.parametrize("bounce", [0, 3, 19])
def test_ctx_streams_equal(keys, bounce):
    pix, smp = keys[0], keys[1]
    jctx = jrng.Ctx(_jax_u32(pix), _jax_u32(smp), jnp.uint32(bounce), jnp.uint32(7))
    tctx = trng.Ctx(torch.from_numpy(pix), torch.from_numpy(smp),
                    torch.full((pix.size,), bounce, dtype=torch.int64), 7)
    for stream in (trng.Streams.PIXEL_JITTER, trng.Streams.LIGHT_SAMPLE + 3,
                   trng.Streams.FRESNEL):
        for w, g in zip(jctx.uniform4(stream), tctx.uniform4(stream)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for w, g in zip(jctx.gaussian3(trng.Streams.SPECULAR),
                    tctx.gaussian3(trng.Streams.SPECULAR)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", ["gaussian2", "gaussian3"])
def test_gaussians_match(keys, fn):
    want = getattr(jrng, fn)(*(_jax_u32(k) for k in keys))
    got = getattr(trng, fn)(*(torch.from_numpy(k) for k in keys))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def _vecs(n=2048, seed=1):
    r = np.random.default_rng(seed)
    a = r.normal(size=(n, 3)).astype(np.float32)
    b = r.normal(size=(n, 3)).astype(np.float32)
    return a, b


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _close(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _cases():
    a, b = _vecs()
    r = np.random.default_rng(2)
    u1 = r.uniform(size=2048).astype(np.float32)
    u2 = r.uniform(size=2048).astype(np.float32)
    cmax = r.uniform(0.2, 1.0, size=2048).astype(np.float32)
    ratio = r.uniform(0.6, 1.6, size=2048).astype(np.float32)
    cos = r.uniform(0.0, 1.0, size=2048).astype(np.float32)
    t = r.uniform(size=2048).astype(np.float32)
    small = (a * np.where(r.uniform(size=(2048, 1)) < 0.5, 1e-9, 1.0)).astype(np.float32)
    ua, ub = _unit(a), _unit(b)
    return {
        "dot": (a, b), "cross": (a, b), "length_squared": (a,), "length": (a,),
        "safe_sqrt": (a[:, 0],), "normalize": (a,), "normalize_eps": (small,),
        "lerp": (a, b, t), "reflect": (a, ub), "refract": (ua, ub, ratio),
        "reflectance": (cos, ratio), "onb_from_vec": (ua,),
        "onb_transform": (ua, ub, _unit(np.cross(ua, ub)), a),
        "near_zero": (small,), "deg_to_rad": (a[:, 0],),
        "square_to_unit_circle": (u1, u2), "square_to_uniform_sphere": (u1, u2),
        "square_to_cosine_hemisphere": (u1, u2),
        "square_to_sphere_cone": (u1, u2, cmax),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_math_helper_matches(name):
    args = _cases()[name]
    fn = name[:-4] if name.endswith("_eps") else name
    extra = (1e-20,) if name.endswith("_eps") else ()
    want = getattr(jmath, fn)(*(jnp.asarray(x) for x in args), *extra)
    got = getattr(tmath, fn)(*(torch.from_numpy(x) for x in args), *extra)
    if name == "near_zero":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want)
