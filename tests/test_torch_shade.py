"""Port texture, light and shading ops against the JAX package, per lane
at rtol 1e-5 / atol 1e-6 (flags and ids equal).  Shading runs on the same
fixed hits on both sides: JAX's hits and hit attributes, handed to the port
as numpy; the RNG draws inside are bit-identical (tests/test_torch_core.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytracer_tpu.core import rng as jrng
from rust_raytracer_tpu.ops import intersect as jisect
from rust_raytracer_tpu.ops import lights as jlights
from rust_raytracer_tpu.ops import shade as jshade
from rust_raytracer_tpu.ops import texture as jtex
from rust_raytracer_tpu.scene import compiler as jcompiler
from rust_raytracer_torch.core import rng as trng
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.ops import lights as tlights
from rust_raytracer_torch.ops import shade as tshade
from rust_raytracer_torch.ops import texture as ttex

from test_torch_intersect import _scene_rays
from test_torch_scene import (jax_graph, mini_dragon_scene, port_pack_from_jax, port_static,
                              texture_scene)

torch.set_num_threads(2)

N = 1536


def _close(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if got.dtype == bool or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=msg)


@pytest.fixture(scope="module")
def texture_pack():
    jp, js = jcompiler.compile_scene(texture_scene(jax_graph()))
    return jp, js, port_pack_from_jax(jp), port_static(js)


def _ctxs(n):
    pix = np.arange(n, dtype=np.int64) * 37 + 11
    smp = np.arange(n, dtype=np.int64) * 3 % 7
    jctx = jrng.Ctx(jnp.asarray(pix, jnp.uint32), jnp.asarray(smp, jnp.uint32),
                    jnp.uint32(2), jnp.uint32(5))
    tctx = trng.Ctx(torch.from_numpy(pix), torch.from_numpy(smp), 2, 5)
    return jctx, tctx


@pytest.mark.parametrize("const", ["tex_const", "static"])
def test_eval_program_every_op(texture_pack, const):
    jp, js, tp, ts = texture_pack
    kinds = {n.kind for n in ts.tex_program}
    assert set(range(8)) <= kinds  # every texture op is in the program
    rng = np.random.default_rng(4)
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    pos = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    want = jtex.eval_program(js.tex_program, jp.tex_data, jnp.asarray(uv), jnp.asarray(pos),
                             tex_const=jp.tex_const if const == "tex_const" else None)
    got = ttex.eval_program(ts.tex_program, tp.tex_data, torch.from_numpy(uv),
                            torch.from_numpy(pos),
                            tex_const=tp.tex_const if const == "tex_const" else None)
    assert got.shape == (len(ts.tex_program), N, 3)
    _close(got, want)
    ids = rng.integers(0, len(ts.tex_program), N)
    _close(ttex.gather_values(got, torch.from_numpy(ids)),
           jtex.gather_values(want, jnp.asarray(ids)))


def test_lights_pdf_and_sample(texture_pack):
    jp, js, tp, ts = texture_pack
    assert {k for k, _ in js.light_list} == {0, 1, 2, 3, 4}
    rng = np.random.default_rng(8)
    org = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    jctx, tctx = _ctxs(N)
    want_d = jlights.lights_sample(jp, js.light_list, jnp.asarray(org), jctx)
    got_d = tlights.lights_sample(tp, ts.light_list, torch.from_numpy(org), tctx)
    _close(got_d, want_d)
    # pdfs along the sampled directions (they hit their lights) and along
    # random ones
    for dirn in (np.array(want_d), rng.normal(size=(N, 3)).astype(np.float32)):
        want = jlights.lights_pdf_value(jp, js.light_list, jnp.asarray(org), jnp.asarray(dirn))
        got = tlights.lights_pdf_value(tp, ts.light_list, torch.from_numpy(org),
                                       torch.from_numpy(dirn))
        _close(got, want)


@pytest.mark.parametrize("name", ["mini_dragon", "texture"])
def test_shade_on_fixed_hits(name):
    jp, tp, org, dirn = _scene_rays(name)
    js = jcompiler.compile_scene(
        {"mini_dragon": mini_dragon_scene, "texture": texture_scene}[name](jax_graph()))[1]
    ts = port_static(js)
    n = org.shape[0]
    jctx, tctx = _ctxs(n)
    jo, jd = jnp.asarray(org), jnp.asarray(dirn)
    jhit = jisect.intersect(jp, jo, jd, 1e-3, jctx, kernel="jnp")
    jattr = jisect.hit_attributes(jp, jo, jd, jhit)
    jvals = jtex.eval_program(js.tex_program, jp.tex_data, jattr.uv, jattr.pos,
                              tex_const=jp.tex_const)
    want = jshade.shade(jp, js.light_list, jvals, jo, jd, jhit, jattr, jctx, 0.25)

    to, td = torch.from_numpy(org), torch.from_numpy(dirn)
    thit = tisect.Hit(*(torch.from_numpy(np.array(x)) for x in jhit))
    tattr = tisect.HitAttributes(*(torch.from_numpy(np.array(x)) for x in jattr))
    tvals = ttex.eval_program(ts.tex_program, tp.tex_data, tattr.uv, tattr.pos,
                              tex_const=tp.tex_const)
    _close(tvals, jvals, "tex_values")
    got = tshade.shade(tp, ts.light_list, tvals, to, td, thit, tattr, tctx, 0.25)
    mats = set(np.asarray(jp.mat_type)[np.asarray(jattr.mat)[np.asarray(jattr.valid)]])
    assert len(mats) >= (2 if name == "mini_dragon" else 6)
    for field in got._fields:
        _close(getattr(got, field), getattr(want, field), field)
