"""The entry point's refusals and the no-JAX rule."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench.core import spec

RUN = [sys.executable, "perfbench/run.py", "--workload", "dragon_render", "--seed",
       str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import perfbench.run as run

    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    monkeypatch.setitem(sys.modules, "rust_raytracer_torch_extra", object())
    found = run.forbidden_modules()
    assert "jax.numpy" in found
    assert "jaxtyping" not in found and "rust_raytracer_torch_extra" not in found


def test_a_run_loads_no_jax():
    """A whole run (tiny, on the CPU) in a process of its own leaves no
    module of JAX or of the JAX package loaded."""
    code = (
        "import sys, functools\n"
        "sys.path.insert(0, '.')\n"
        "from rust_raytracer_torch.utils import procgen\n"
        "procgen.torus_knot_mesh = functools.partial(procgen.torus_knot_mesh, rings=30, segments=12)\n"
        "import perfbench.run as run\n"
        "from perfbench.core import spec\n"
        "cell = spec.load_cell('dragon_render')\n"
        "cell.config['camera']['image_width'] = 12\n"
        "cell.config.update(knot_rings=30, knot_segments=12, lanes=1024, samples_per_pixel=4)\n"
        "cell.traffic['check_pixels'] = 16\n"
        "res = run.run_cell(cell, 5, 0.01, False, device='cpu')\n"
        "print(res['correct'], run.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_no_card_no_result():
    """Without CUDA the run exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(RUN, cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the files under
    `paths` gives no result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    for p in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(spec.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(RUN, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.mark.cuda
def test_control_fails_on_the_card():
    """On the card, at the cell's own size: the control comes out not
    correct (perfbench/control.py, as its chip runs in PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at full size runs on the chip")
    from perfbench import control

    cell = spec.load_cell("dragon_render")
    numbers = control.control_numbers(cell, 11, torch.device("cuda"))
    assert numbers["pixel_mismatch_share"] > cell.limits["pixel_mismatch_share"]
