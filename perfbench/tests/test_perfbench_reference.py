"""The plain reference (perfbench/reference/) against the program at tiny
sizes on the CPU: a 32x32 `cornell` render, a mini `cornell_dragon`, one
small fwd+bwd step.  The test imports both; the reference imports
neither the program nor JAX."""
import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.core import check, spec
from perfbench.tests.small import KNOT

REF_DIR = Path(spec.ROOT) / "perfbench" / "reference"


def _camera(cfg, width, spp):
    from rust_raytracer_torch.render.camera import Camera

    return Camera(**{**cfg["camera"], "image_width": width}, samples_per_pixel=spp,
                  max_depth=cfg["max_depth"], light_bias=cfg["light_bias"])


def _small_knot(monkeypatch, cell):
    from rust_raytracer_torch.utils import procgen

    monkeypatch.setattr(procgen, "torus_knot_mesh",
                        functools.partial(procgen.torus_knot_mesh, **KNOT))
    cell.config.update(knot_rings=KNOT["rings"], knot_segments=KNOT["segments"])


def test_reference_imports_neither_program_nor_jax():
    banned = {"rust_raytracer_torch", "rust_raytracer_tpu", "jax", "jaxlib", "flax"}
    files = list(REF_DIR.glob("*.py")) + list((REF_DIR.parent / "scenes").glob("*.py"))
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not {n.split(".")[0] for n in names} & banned, (f, names)


@pytest.mark.parametrize("scene,width,spp", [("cornell", 32, 4), ("cornell_dragon", 24, 4)])
def test_reference_render_equals_program(scene, width, spp, monkeypatch):
    """Every pixel's radiance sum of a pool render agrees with the
    reference's to float order (no path takes another way at this size):
    the analytic `cornell` (planes, a box, a glass sphere) and a mini
    `cornell_dragon`, under dragon_render's camera and depth."""
    from rust_raytracer_torch import models
    from rust_raytracer_torch.render.renderer import Renderer

    cell = spec.load_cell("dragon_render")
    cell.config["scene"] = scene
    _small_knot(monkeypatch, cell)
    cell.config["camera"]["image_width"] = width
    cam = _camera(cell.config, width, spp)
    film = Renderer(models.build(cell.config["scene"]), cam, seed=7, batch_size=2048,
                    device="cpu").render(mode="pool")
    n = width * width
    ref = check.Reference(cell, "cpu", spp).pixel_sums(np.arange(n), [7], spp)[0]
    got = film.accum.reshape(n, 3)
    assert check.pixel_mismatch(got[None], ref[None])["pixel_mismatch_share"] == 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_reference_grad_step_equals_program(monkeypatch):
    """The loss and every table's gradient norm of one small fwd+bwd step
    agree with the reference's."""
    from rust_raytracer_torch import models
    from rust_raytracer_torch.core import rng as vrng
    from rust_raytracer_torch.render import graphs, integrator
    from rust_raytracer_torch.scene import compiler

    cell = spec.load_cell("dragon_grad")
    _small_knot(monkeypatch, cell)
    width, lanes = 24, 512
    cell.config["camera"]["image_width"] = width
    cam = _camera(cell.config, width, 1)
    pack, static = compiler.compile_scene(models.build(cell.config["scene"]), "cpu")
    gen = torch.Generator().manual_seed(5)
    pix = torch.randint(0, width * width, (lanes,), generator=gen)
    target = torch.rand((lanes, 3), generator=gen)
    smp = torch.full((lanes,), 3)
    px, py = pix % width, pix // width

    def loss(pack, px, py, smp, target, seed):
        ctx = vrng.Ctx(pixel=py * width + px, sample=smp, bounce=0, seed=seed)
        org, dirn = cam.generate_rays(px, py, smp, ctx)
        rad = integrator.trace(pack, static, org, dirn, ctx, cam.max_depth, cam.light_bias,
                               compact=False, differentiable=True, remat="none")
        return ((rad - target) ** 2).mean()

    value, grads = graphs.value_and_grad(loss, pack.with_grad(), px, py, smp, target,
                                         torch.tensor(11))
    prog = {"loss": float(value), "norms": {f: float(g.double().norm())
                                            for f, g in zip(pack.float_fields(), grads)}}
    want = check.Reference(cell, "cpu", 1).grad_step(px, py, smp, target, 11)
    gaps = check.grad_gaps([prog], [want])
    assert gaps["loss_gap"] < 1e-6 and gaps["grad_norm_gap"] < 1e-5, gaps
    assert want["norms"]["tri_attr"] > 0 and want["norms"]["pln_normal"] > 0
