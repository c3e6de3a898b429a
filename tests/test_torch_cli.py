"""The port's command-line path (rust_raytracer_torch/utils/cli.py and what
it reaches) against the JAX package, on the CPU.

- `config.parse_args` equals the JAX parser on a table of argument lists.
- The scene DSL and the glTF / FBX / COLLADA importers are the port's own
  copies: the same scene text and the same fixture files (written by the
  JAX package's tests' fixture writers) go through both packages, and the
  two compilers' packs are equal leaf for leaf.
- `cli.main([...], device="cpu")` renders a builtin, a DSL file and a
  `model:` glTF to a PNG; `--metrics=1` prints one JSON line whose
  `samples_issued` is the image's pixel-samples; `--profile=DIR` writes a
  torch.profiler trace; without CUDA and without device="cpu" it raises.
- RenderMetrics.emit() puts the overflow warning on stderr, the JSON line
  alone on its stream; debug_nans raises at the step whose outputs hold a
  NaN and changes nothing when no NaN is made.
Every comparison here is exact."""
import contextlib
import dataclasses
import io
import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from rust_raytracer_tpu.scene import dsl as jdsl
from rust_raytracer_tpu.utils import config as jconfig
from rust_raytracer_tpu.utils import model_import as jmodel_import
from rust_raytracer_torch import models as tmodels
from rust_raytracer_torch.render import camera as tcam
from rust_raytracer_torch.render import integrator as tintegrator
from rust_raytracer_torch.render import pool as tpool
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.scene import dsl as tdsl
from rust_raytracer_torch.utils import cli
from rust_raytracer_torch.utils import config as tconfig
from rust_raytracer_torch.utils import metrics as tmetrics
from rust_raytracer_torch.utils import model_import as tmodel_import

from test_torch_scene import REPO, assert_compilers_equal

torch.set_num_threads(2)

ARGS = [
    [],
    ["cornell"],
    ["scene.dsl", "-w=64", "-r=1.25", "-f=35", "-a=2.8", "-d=4.5"],
    ["-c=1,2,3", "-l=0,0.5,-1", "-b=0.1,0.2,0.3", "-t=4", "-s=17", "--max-depth=5"],
    ["--width=32", "--aspect-ratio=2", "--focal-length=20", "--aperture=8",
     "--focus-dist=3", "--camera-position=0,1,2", "--look-at=3,4,5",
     "--background-color=1,1,1", "--threads=2", "--samples=9"],
    ["--light-bias=0.5", "--seed=7", "-o=x.png", "--output=y.ppm", "--metrics=1",
     "--profile=trace_dir", "model:a.glb"],
    ["--metrics=no", "-unknown=3", "-w", "-w=5=6", "plain", "--metrics=FALSE", "last"],
]


@pytest.mark.parametrize("argv", ARGS, ids=[str(i) for i in range(len(ARGS))])
def test_parse_args_matches_jax(argv):
    j_name, j_scene, j_render = jconfig.parse_args(list(argv))
    t_name, t_scene, t_render = tconfig.parse_args(list(argv))
    assert t_name == j_name
    assert t_scene == j_scene
    assert dataclasses.asdict(t_render) == dataclasses.asdict(j_render)


def test_parse_args_rejects_what_jax_rejects():
    for argv in (["-c=1,2"], ["--light-bias=1.5"]):
        with pytest.raises(AssertionError):
            jconfig.parse_args(argv)
        with pytest.raises(AssertionError):
            tconfig.parse_args(argv)


OBJ = """\
v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
v 0 1.5 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 1 0
f 1/1/1 2/2/1 5/3/1
f 2/2/1 3/3/1 5/4/1
f 3/3/1 4/4/1 5/1/1
f 4/4/1 1/1/1 5/2/1
"""

DSL = """\
# a small room: every entity kind the loader knows, a mesh and a volume
@config output_width = 24
@config aspect_ratio = 4/3
@config focal_length = 35
@config camera_pos = 0,1,6
@config camera_target = 0,0.5,0
white: lambertian (constant 0.73,0.73,0.73)
red: lambertian (constant 0.65,0.05,0.05)
light_mat: emissive (constant 12,12,12)
check: checker (constant 0.1,0.1,0.1) (constant 0.9,0.9,0.9) 0.5
solid: checker_solid (constant 0.8,0.2,0.2) (constant 0.2,0.2,0.8) 0.3
noise: perlin
marble: noise_solid $noise 2.0 5
mix: lerp (constant 0.1,0.1,0.1) (constant 0.9,0.8,0.7) $marble
rough: channel $solid 1
floor: plane 0,0,0 -4,0,0 0,0,4 (lambertian $check)
back: plane 0,2,-3 3,0,0 0,2,0 $white
light: plane 0,3.99,0 1,0,0 0,0,1 $light_mat backface
glass: sphere -1.2,0.6,0.5 0.6 (glass 1.5)
metal: sphere 1.2,0.5,0.2 0.5 (metal $solid (constant 0.2))
gloss: sphere 0,0.4,1.4 0.4 (glossy $mix $rough 1.45)
box: box 0,0,0 1,1,1 $red
box: transform $box ry=30 s=0.8 t=0.3,0.4,-1.5
pyramid: transform (mesh pyramid.obj $white) s=0.5 t=-1.5,0,-1
fog: volume (sphere 1.5,1.2,-1 0.6 $white) (isotropic (constant 0.9,0.9,0.9)) 0.8
bad: unknown_type 1 2 3
world: list $floor $back $light $glass $metal $gloss $box $pyramid $fog
lights: list $light $glass
"""


@pytest.fixture(scope="module")
def dsl_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("dsl")
    (d / "pyramid.obj").write_text(OBJ)
    (d / "room.dsl").write_text(DSL)
    return str(d / "room.dsl")


def test_dsl_leaves_equal_jax(dsl_path):
    """The same DSL file through both packages' loaders and compilers: every
    leaf equal; the line with an unknown type warns and is skipped in both."""
    jscene = jdsl.load_scene_file(dsl_path, perlin_seed=3)
    tscene = tdsl.load_scene_file(dsl_path, perlin_seed=3)
    assert tscene.config == jscene.config
    assert len(tscene.world.items) == 9
    assert_compilers_equal(jscene, tscene)
    leaves, _, _ = tcompiler.compile_numpy(tscene)
    assert leaves["vol_kind"].shape[0] == 1 and leaves["tri_v0"].shape[0] >= 4


def test_dsl_errors_match_jax():
    for text in ("garbage here\nsky: sky (constant 1,1,1)\n",
                 "sky: sky (constant 1,1,1)\nworld: list $sky\n"):
        with pytest.raises(jdsl.DslError):
            jdsl.SceneLoader().load(text)
        with pytest.raises(tdsl.DslError):
            tdsl.SceneLoader().load(text)


def _gltf_fixture(path):
    from test_gltf import _build_glb

    _build_glb(path)


def _fbx_fixture(path):
    from test_fbx import _build_fixture

    _build_fixture(path)


def _dae_fixture(path):
    from test_collada import DAE

    with open(path, "w") as f:
        f.write(DAE)


FIXTURES = {"fixture.glb": _gltf_fixture, "quad.fbx": _fbx_fixture, "test.dae": _dae_fixture}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_model_import_leaves_equal_jax(name, tmp_path):
    """The importer fixtures of test_gltf.py, test_fbx.py and
    test_collada.py through both packages' `load_model`: the same camera
    config and every compiled leaf equal."""
    path = str(tmp_path / name)
    FIXTURES[name](path)
    jscene = jmodel_import.load_model(path)
    tscene = tmodel_import.load_model(path)
    assert tscene.config == jscene.config
    assert_compilers_equal(jscene, tscene)


def _read_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = hdr[:2]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return raw[:, 1:].reshape(h, w, 3)


def _run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv, device="cpu")
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    return rc, lines


def test_cli_renders_builtin_scene(tmp_path):
    out = tmp_path / "out.png"
    rc, lines = _run_cli(["test", "-w=32", "-s=4", "--max-depth=3", f"-o={out}",
                          "--metrics=1"])
    assert rc == 0
    img = _read_png(out)
    assert img.shape == (21, 32, 3) and img.max() > 0  # 32 wide, aspect 1.5
    assert len(lines) == 1
    m = lines[0]["render_metrics"]
    assert m["samples_issued"] == m["pixel_samples"] == 32 * 21 * 4
    assert m["steps"] > 0 and m["pixel_samples_per_s"] > 0


def test_cli_renders_dsl_file(dsl_path, tmp_path):
    out = tmp_path / "room.png"
    rc, lines = _run_cli([dsl_path, "-s=4", "--max-depth=4", f"-o={out}", "--metrics=1"])
    assert rc == 0
    img = _read_png(out)
    assert img.shape == (18, 24, 3) and img.max() > 0  # @config 24 wide, 4/3
    assert lines[0]["render_metrics"]["samples_issued"] == 24 * 18 * 4


def test_cli_renders_model_import(tmp_path):
    path = str(tmp_path / "fixture.glb")
    _gltf_fixture(path)
    out = tmp_path / "model.png"
    rc, lines = _run_cli([f"model:{path}", "-w=20", "-s=1", "--max-depth=3", f"-o={out}",
                          "--metrics=1"])
    assert rc == 0
    h = int(20 / jmodel_import.load_model(path).config["aspect_ratio"])
    assert _read_png(out).shape == (h, 20, 3)
    assert lines[0]["render_metrics"]["samples_issued"] == 20 * h


def test_cli_profile_flag_writes_trace(tmp_path):
    out = tmp_path / "out.png"
    prof = tmp_path / "trace"
    rc, lines = _run_cli(["test", "-w=16", "-s=1", "--max-depth=2", f"-o={out}",
                          f"--profile={prof}"])
    assert rc == 0 and not lines  # no --metrics, no JSON line
    traces = [f for f in os.listdir(prof) if f.endswith(".json")]
    assert len(traces) == 1
    trace = json.load(open(prof / traces[0]))
    assert trace["traceEvents"]


def test_cli_without_cuda_raises(tmp_path):
    """The CLI renders on the card unless asked for the CPU: without CUDA
    main() and `python -m rust_raytracer_torch` fail; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-fallback rule is moot here")
    out = tmp_path / "out.png"
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["test", "-w=8", "-s=1", f"-o={out}"])
    run = subprocess.run([sys.executable, "-m", "rust_raytracer_torch", "test", "-w=8",
                          "-s=1", f"-o={out}"], capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO))
    assert run.returncode != 0 and "torch.cuda.is_available() is False" in run.stderr
    assert not out.exists()


def test_overflow_warning_goes_to_stderr(capsys):
    m = tmetrics.RenderMetrics(n_pixels=100, spp=1, samples_issued=100,
                               wf_overflow_packets=5, wf_total_packets=1000)
    line = m.emit()
    out, err = capsys.readouterr()
    assert out == line + "\n"
    assert json.loads(out)["render_metrics"]["wf_overflow_frac"] == 0.005
    assert "WARNING" in err and "kernel='bvh8'" in err and "pallas" not in err
    m.wf_overflow_packets = 1  # 0.1%: no warning
    m.emit()
    out, err = capsys.readouterr()
    assert err == "" and out.startswith('{"render_metrics"')


def _small_pool():
    scene = tmodels.build("cornell_smoke")
    sc = tconfig.merge_scene_config(scene.config, {"output_width": 12})
    cam = tcam.camera_from_config(sc, tconfig.RenderConfig(samples_per_pixel=1, max_depth=4))
    pack, static = tcompiler.compile_scene(scene, "cpu")
    return pack, static, cam


def test_debug_nans_raises_at_the_step():
    """Off: a pool render and a trace run as before.  On: the same give the
    same result; a NaN in the lane state raises FloatingPointError at the
    pool step and at the trace bounce that carry it."""
    pack, static, cam = _small_pool()
    n_pixels = cam.image_width * cam.image_height
    want = tpool.render_pool(pack, static, cam, n_pixels, 1, 64, "cpu")
    with tmetrics.debug_nans():
        assert tmetrics.nan_checks()
        got = tpool.render_pool(pack, static, cam, n_pixels, 1, 64, "cpu")
    assert not tmetrics.nan_checks()
    assert torch.equal(got, want)

    step = tpool.make_step(pack, static, cam, n_pixels, 1, 0)
    state = step(pack, tpool.init_state(64, n_pixels, "cpu"))
    bad = state._replace(throughput=state.throughput.clone())
    bad.throughput[bad.active.nonzero()[0, 0]] = float("nan")
    step(pack, bad)  # off: no check
    with tmetrics.debug_nans(), pytest.raises(FloatingPointError, match="pool step"):
        step(pack, bad)

    from rust_raytracer_torch.core import rng as trng

    n = 32
    px, py = torch.arange(n) % cam.image_width, torch.arange(n) // cam.image_width
    ctx = trng.Ctx(py * cam.image_width + px, torch.zeros(n, dtype=torch.int64), 0, 0)
    org, dirn = (x.clone() for x in cam.generate_rays(px, py, ctx.sample, ctx))
    with tmetrics.debug_nans():
        ok = tintegrator.trace(pack, static, org, dirn, ctx, 4, cam.light_bias)
    assert torch.isfinite(ok).all()
    dirn[3] = float("nan")
    with tmetrics.debug_nans(), pytest.raises(FloatingPointError, match="trace bounce 0"):
        tintegrator.trace(pack, static, org, dirn, ctx, 4, cam.light_bias)
