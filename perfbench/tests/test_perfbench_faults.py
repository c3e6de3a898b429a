"""A run with its timed path broken underneath comes out not correct: each
fault a cell can have, planted in the program at a tiny size on the CPU,
and the rest of the run (the window, the metrics, the comparison with the
reference under the cell's own limits) left as it is."""
import pytest
import torch

import perfbench.run as run
from perfbench.tests.small import small_cell


def _state_unchanged_pool(monkeypatch):
    from rust_raytracer_torch.render import pool

    monkeypatch.setattr(pool, "make_step", lambda *a, **k: (lambda pack, state: state))


def _half_samples(monkeypatch):
    """Half of each pixel's samples left out, the mean taken over the rest."""
    from rust_raytracer_torch.render.renderer import Renderer

    orig = Renderer.render

    def render(self, spp=None, mode="pool", metrics=None):
        full = self.camera.actual_spp
        film = orig(self, spp=full // 2, mode=mode, metrics=metrics)
        film.accum = film.accum * (full / (full // 2))
        return film

    monkeypatch.setattr(Renderer, "render", render)


def _altered_emission(monkeypatch):
    """The emission a vertex produces off by 10%: an answer altered where it
    is made."""
    from rust_raytracer_torch.render import integrator

    orig = integrator.shade_hits

    def shade_hits(*a, **k):
        emission, *rest = orig(*a, **k)
        return (emission * 1.1, *rest)

    monkeypatch.setattr(integrator, "shade_hits", shade_hits)


def _planes_not_joined(monkeypatch):
    from rust_raytracer_torch.render import pool

    monkeypatch.setattr(pool, "sum_planes",
                        lambda mesh, state, device: state[0].accum.to(device, copy=True))


def _stale_grad(monkeypatch):
    """Every step returns the first step's loss and gradients."""
    from rust_raytracer_torch.render import graphs

    orig, first = graphs.value_and_grad, []

    def value_and_grad(fn, pack, *lanes):
        if not first:
            first.append(orig(fn, pack, *lanes))
        return first[0]

    monkeypatch.setattr(graphs, "value_and_grad", value_and_grad)


def _half_lanes(monkeypatch):
    """The loss and gradients of half of the lanes (the mean over them)."""
    from rust_raytracer_torch.render import graphs

    orig = graphs.value_and_grad

    def value_and_grad(fn, pack, *lanes):
        half = lanes[0].shape[0] // 2
        return orig(fn, pack, *(x[:half] for x in lanes[:4]), *lanes[4:])

    monkeypatch.setattr(graphs, "value_and_grad", value_and_grad)


CASES = [
    ("dragon_render", _state_unchanged_pool),
    ("dragon_render", _half_samples),
    ("dragon_render", _altered_emission),
    ("dragon_render.4", _planes_not_joined),
    ("dragon_render.4", _altered_emission),
    ("dragon_grad", _stale_grad),
    ("dragon_grad", _half_lanes),
    ("dragon_grad", _altered_emission),
]


@pytest.mark.parametrize("workload,fault", CASES, ids=[f"{w}-{f.__name__[1:]}" for w, f in CASES])
def test_planted_fault_is_not_correct(workload, fault, monkeypatch):
    name, _, shards = workload.partition(".")
    cell = small_cell(name, monkeypatch, shards=int(shards or 1))
    fault(monkeypatch)
    res = run.run_cell(cell, 2 ** 31 + 17, 0.05, False, device="cpu")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload,shards", [("dragon_render", 1), ("dragon_render", 4),
                                             ("dragon_grad", 1)])
def test_sound_run_is_correct(workload, shards, monkeypatch):
    """The same runs with nothing planted come out correct ("dragon_render.4":
    the renders over a mesh of four shards)."""
    cell = small_cell(workload, monkeypatch, shards=shards)
    res = run.run_cell(cell, 2 ** 31 + 17, 0.05, False, device="cpu")
    assert res["correct"] is True, res["checks"]
    assert torch.cuda.is_available() or res["device"]["platform"] == "cpu"
