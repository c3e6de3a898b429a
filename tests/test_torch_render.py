"""The port's render path against the JAX package: pool steps, a whole pool
render of the mini cornell_dragon, the cornell golden image, and the film.

The port's arithmetic differs from XLA's on the CPU in the last ulp: XLA
contracts a*b+c into FMAs and has its own log/sin/cos approximations,
torch's CPU sqrt is not always correctly rounded (measured on 10^6 random
f32 inputs: 16% of a*b+a, 14% of log, 5% of sin/cos, 0.6% of sqrt differ by
1 ulp).  State drifts apart by a few 1e-6 of the scene's scale over a few
bounces, and a rare edge hit that flips on that drift changes one lane's
whole path.  Image comparisons are therefore statistical: mean |d| / mean
<= 1e-3 and a fraction of pixels within tolerance (ROADMAP Queue 3 records
the measured numbers)."""
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from rust_raytracer_tpu.render import film as jfilm
from rust_raytracer_tpu.render import pool as jpool
from rust_raytracer_tpu.render.renderer import Renderer as JRenderer
from rust_raytracer_tpu.utils import config as cfg
from rust_raytracer_torch import models as tmodels
from rust_raytracer_torch.render import camera as tcam
from rust_raytracer_torch.render import film as tfilm
from rust_raytracer_torch.render import pool as tpool
from rust_raytracer_torch.render.renderer import Renderer as TRenderer
from rust_raytracer_torch.utils import metrics as tmetrics

from rust_raytracer_torch.scene import graph as tg

from test_torch_scene import jax_graph, mini_dragon_scene, port_pack_from_jax, port_static

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
LANES = 1024


@pytest.fixture(scope="module")
def mini():
    """The port's mini scene, one JAX renderer (kernel="jnp") of the JAX
    package's and the port's camera, at 32x32, 4 spp, depth 8."""
    scene = mini_dragon_scene(tg)
    sc = cfg.merge_scene_config(scene.config, {"output_width": 32})
    rc = cfg.RenderConfig(samples_per_pixel=4, max_depth=8)
    jr = JRenderer(mini_dragon_scene(jax_graph()), cfg.make_camera(sc, rc), batch_size=LANES,
                   kernel="jnp")
    return scene, jr, tcam.camera_from_config(sc, rc)


def _by_job(pixel, sample, active, *cols):
    """Active lanes' columns ordered by (pixel, sample)."""
    pixel, sample, active = (np.asarray(x) for x in (pixel, sample, active))
    idx = np.nonzero(active)[0]
    order = idx[np.lexsort((sample[idx], pixel[idx]))]
    return [np.asarray(c)[order] for c in (pixel, sample) + cols]


def test_pool_steps_match_jax(mini):
    """Five pool steps of the port and of JAX (kernel="jnp") from the same
    start: the same jobs in flight at the same bounce, and every state
    column and the image accumulator within rtol 1e-4 / atol 2e-5 of the
    column's scale (measured drift after 5 steps: 6.0e-6 of the scene scale
    in org, 1.8e-6 in throughput, 3.2e-5 relative in the accumulator).  Lanes are compared in (pixel, sample) order because the
    sort may order equal keys differently."""
    scene, jr, cam = mini
    n_pixels = cam.image_width * cam.image_height
    spp = cam.actual_spp
    total = n_pixels * spp
    jstep = jpool.make_step(jr.pack, jr.static, jr.camera, total, spp, 0, kernel="jnp")
    tpack = port_pack_from_jax(jr.pack)
    tstep = tpool.make_step(tpack, port_static(jr.static), cam, total, spp, 0)
    js = jpool.init_state(LANES, n_pixels)
    ts = tpool.init_state(LANES, n_pixels, "cpu")
    cols = ("org", "dirn", "throughput", "radiance", "bounce")
    for k in range(5):
        js = jstep(jr.pack, js)
        ts = tstep(tpack, ts)
        assert int(ts.next_flat) == int(js.next_flat[0])
        got = _by_job(ts.pixel, ts.sample, ts.active, *(getattr(ts, c) for c in cols))
        want = _by_job(js.pixel, js.sample, js.active, *(getattr(js, c) for c in cols))
        np.testing.assert_array_equal(got[0], want[0])  # same jobs in flight
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[-1], want[-1])  # bounce
        for name, g, w in zip(cols[:-1], got[2:-1], want[2:-1]):
            scale = max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-5 * scale,
                                       err_msg=f"step {k} {name}")
    want = np.asarray(js.accum[0])
    np.testing.assert_allclose(ts.accum.numpy(), want, rtol=1e-4,
                               atol=2e-5 * max(float(np.abs(want).max()), 1.0))


def _image_close(got, want):
    rel = np.abs(got - want).mean() / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    assert rel <= 1e-3, rel
    assert close >= 0.995, close
    return rel, close


def test_pool_render_matches_jax(mini):
    scene, jr, cam = mini
    want = jr.render(mode="pool").hdr()
    r = TRenderer(scene, cam, batch_size=LANES, device="cpu")
    metrics = tmetrics.RenderMetrics()
    got = r.render(mode="pool", metrics=metrics).hdr()
    assert got.shape == want.shape and np.isfinite(got).all()
    occupancy = metrics.summary()["mean_occupancy"]
    assert metrics.steps > 0 and 0 < occupancy <= LANES
    _image_close(got, want)


def test_cornell_pool_render_matches_golden():
    """The port's pool render of cornell at 64 px / 49 spp / depth 20
    against the committed golden (JAX batch render, test_golden.py) at its
    rtol = atol = 2e-4, with no JAX run.  Measured: 44 of 4096 pixels
    (1.07%) outside 2e-4, each holding one flipped path among its 49 (41 of
    131,712 paths differ; max |d| 0.3049 = 14.94 / 49, under one path of
    the light's radiance 15); mean |d| / mean 6.0e-4; the same numbers with
    1, 2 and 4 threads and 2^14 or 2^16 lanes.  Required: at most 48 pixels
    outside 2e-4, each within 15 / 49 + 2e-4, and mean |d| / mean <= 1e-3
    (ROADMAP Queue 3)."""
    scene = tmodels.build("cornell")
    sc = cfg.merge_scene_config(scene.config, {"output_width": 64})
    cam = tcam.camera_from_config(sc, cfg.RenderConfig(samples_per_pixel=49, max_depth=20))
    got = TRenderer(scene, cam, batch_size=1 << 16, device="cpu").render(mode="pool").hdr()
    ref = np.load(os.path.join(HERE, "golden", "cornell_64.npy"))
    got = got.astype(np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    outside = ~np.isclose(got, ref, rtol=2e-4, atol=2e-4).all(axis=-1)
    d = np.abs(got - ref).max(axis=-1)
    rel = np.abs(got - ref).mean() / ref.mean()
    assert outside.sum() <= 48, outside.sum()
    assert d.max() <= 15.0 / 49 + 2e-4, d.max()  # at most one path of the light
    assert rel <= 1e-3, rel


def test_unported_modes_raise(mini):
    """Both render modes and every port kernel are accepted; the reference's
    "pallas" kernel and an unknown mode are refused by name.  Scenes with
    volumes are ported: cornell_smoke renders in both modes."""
    scene, _, cam = mini
    r = TRenderer(scene, cam, kernel="threaded", device="cpu")
    assert r.kernel == "threaded"
    assert TRenderer(scene, cam, kernel="wavefront", device="cpu").kernel == "wavefront"
    with pytest.raises(ValueError, match="unknown mode"):
        r.render(mode="tiles")
    with pytest.raises(ValueError, match="unknown kernel"):
        TRenderer(scene, cam, kernel="pallas", device="cpu")
    smoke = tmodels.build("cornell_smoke")
    sc = cfg.merge_scene_config(smoke.config, {"output_width": 16})
    smoke_cam = tcam.camera_from_config(sc, cfg.RenderConfig(samples_per_pixel=4, max_depth=6))
    r = TRenderer(smoke, smoke_cam, batch_size=512, device="cpu")
    pool, batch = (r.render(mode=m).hdr() for m in ("pool", "batch"))
    assert pool.shape == (16, 16, 3) and np.isfinite(pool).all() and pool.mean() > 0
    np.testing.assert_allclose(pool, batch, rtol=1e-5, atol=1e-6)  # same paths, sum order


def _hdr():
    r = np.random.default_rng(6)
    hdr = r.lognormal(-1.0, 1.5, (9, 13, 3))
    hdr[0, 0] = 0.0
    hdr[0, 1] = 1e-4
    hdr[0, 2] = 100.0
    return hdr


@pytest.mark.parametrize("tonemap", ["aces", "clamp"])
def test_film_to_image_matches_jax(tonemap):
    hdr = _hdr()
    jf, tf = jfilm.Film(13, 9), tfilm.Film(13, 9)
    jf.add_samples(hdr * 4, 4)
    tf.add_samples(torch.from_numpy(hdr * 4), 4)
    want = jf.to_image(tonemap).astype(int)
    got = tf.to_image(tonemap)
    assert got.dtype == np.uint8 and got.shape == (9, 13, 3)
    assert np.abs(got.astype(int) - want).max() <= 1


def _read_png(data):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(kind + body)
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = hdr[:2]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_film_writers_round_trip(tmp_path):
    f = tfilm.Film(13, 9)
    f.add_samples(_hdr(), 1)
    img = f.to_image()
    png = f.save(str(tmp_path / "out.png"))
    np.testing.assert_array_equal(_read_png(open(png, "rb").read()), img)
    ppm = open(f.save(str(tmp_path / "out.ppm")), "rb").read()
    head = b"P6\n13 9\n255\n"
    assert ppm.startswith(head)
    np.testing.assert_array_equal(np.frombuffer(ppm[len(head):], np.uint8).reshape(9, 13, 3), img)


def test_film_ppm_writers_match_jax(tmp_path):
    """save_ppm_p3 (the reference's legacy gamma-2.2 ASCII writer) writes
    the reference's bytes; save_ppm writes the reference's P6 header and its
    pixels within test_film_to_image_matches_jax's 1 of 255."""
    hdr = _hdr()
    jf, tf = jfilm.Film(13, 9), tfilm.Film(13, 9)
    jf.add_samples(hdr * 4, 4)
    tf.add_samples(torch.from_numpy(hdr * 4), 4)
    read = lambda p: open(p, "rb").read()  # noqa: E731
    assert read(tf.save_ppm_p3(str(tmp_path / "t3.ppm"))) == read(
        jf.save_ppm_p3(str(tmp_path / "j3.ppm")))
    got, want = (read(f.save_ppm(str(tmp_path / f"{n}6.ppm"))) for f, n in ((tf, "t"), (jf, "j")))
    head = b"P6\n13 9\n255\n"
    assert got.startswith(head) and want.startswith(head) and len(got) == len(want)
    body = np.frombuffer(got[len(head):], np.uint8).astype(int)
    assert np.abs(body - np.frombuffer(want[len(head):], np.uint8).astype(int)).max() <= 1
    np.testing.assert_array_equal(body.reshape(9, 13, 3), tf.to_image())
