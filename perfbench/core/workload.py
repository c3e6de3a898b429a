"""The system under test, driven by a cell's traffic mix: one general
runner, whose parameters all come from the configuration file and the
traffic file (perfbench/traffic/<traffic>.json, key `loop`):

- "renders": a closed loop of whole pool renders, back to back, by one
  Renderer whose seed is fixed for the run (`kernel`; the configuration's
  spp).  Each render's image comes to the host (Film) before the next.
- "grad_steps": a closed loop of fwd+bwd steps of `lanes` lanes, one sample
  a lane at pixels drawn from the seed over the whole image, sample id =
  the step's index, depth and light bias the configuration's, an L2 loss
  against a target image drawn from the seed, the gradients of every float
  table of the scene; replayed as one graph a step on the card
  (render/graphs.py:GraphedGrad).

Set-up builds the kernels, the program's scene and camera from the
configuration, and runs the first units (`warm_units`), which capture the
graphs that the window replays; its parts are timed apart, and whether it
built a library of build/rrt_torch/ (a checkout's first run) is recorded.
Each later unit is timed from its request to its result on the host.  The window runs units until one ends
at or after `seconds` from the window's start, so a rate is taken over
whole units.  With tracing on, the profiler records the first
`trace_units` units of the window.

The program is driven from here (core/spans.py wraps some of its calls in
traced runs); nothing of the reference is imported here.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

TRACE_SPAN = "perfbench.window"
LIBRARIES = Path(__file__).resolve().parents[2] / "build" / "rrt_torch"


def derive_seed(seed: int, *keys: int) -> int:
    """A 32-bit seed derived from the run's seed and integer `keys` (any
    whole numbers, negative ones included)."""
    words = [int(x) % (1 << 64) for x in (seed, *keys)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint32)[0])


def check_rows(seed: int, n_pixels: int, k: int) -> np.ndarray:
    """The `k` pixels (sorted, distinct) whose results the comparison reads,
    drawn from the run's seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), 1]))
    return np.sort(rng.choice(n_pixels, size=min(k, n_pixels), replace=False))


def target_image(seed: int, n_pixels: int, device) -> torch.Tensor:
    """The grad steps' target image (n_pixels, 3), uniform in [0, 1), made
    on the device from the run's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, 2))
    return torch.rand((n_pixels, 3), generator=gen, device=device)


def step_inputs(seed: int, k: int, lanes: int, target: torch.Tensor):
    """(pixel ids, sample ids, target rows) of grad step k: `lanes` pixels
    drawn uniformly over the image from the run's seed, sample id k."""
    gen = torch.Generator(device=target.device)
    gen.manual_seed(derive_seed(seed, 3, k))
    pix = torch.randint(0, target.shape[0], (lanes,), generator=gen, device=target.device)
    smp = torch.full((lanes,), k, dtype=torch.int64, device=target.device)
    return pix, smp, target[pix]


def library_stamps() -> dict:
    """{file: modification time} of the program's built libraries."""
    return {p.name: p.stat().st_mtime_ns for p in sorted(LIBRARIES.glob("*.so"))}


@dataclasses.dataclass
class Unit:
    """One unit of work of the window: a render or a step."""
    start: float
    end: float
    pixel_samples: int
    finite: bool
    counters: Optional[object] = None


@dataclasses.dataclass
class Outcome:
    """What the runner hands on: the window's units, the set-up's seconds,
    its parts' seconds and whether it built a library, the device and its
    peak memory, the traced window's DeviceTrace (with
    --trace 1), and what the comparison with the reference reads (the
    program's outputs and the inputs both sides get)."""
    units: List[Unit]
    setup_s: float
    setup_parts: Dict[str, float]
    setup_built: bool
    window_s: float
    devices: tuple
    memory_peak_bytes: int
    window_peak_bytes: int
    trace: Optional[object]
    traced_units: List[Unit]
    answers: dict
    sizes: dict


def _sync(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Runner:
    """The program under one cell's traffic on `device` ("cuda" on the chip;
    the CPU in the harness's tests, with the plain versions)."""

    def __init__(self, cell, seed: int, device: str = "cuda"):
        self.marks = [("imports", time.perf_counter())]
        self.stamps = library_stamps()
        from rust_raytracer_torch import models
        from rust_raytracer_torch.render.camera import Camera

        self.cell, self.seed = cell, int(seed)
        self.config, self.traffic = cell.config, cell.traffic
        self.loop = self.traffic["loop"]
        self.device = torch.device(device)
        if self.device.type == "cuda":
            from rust_raytracer_torch.ops import _cuda
            _cuda.build_library()
        self.marks.append(("kernels", time.perf_counter()))
        self.run_seed = derive_seed(seed, 0)
        self.spp = int(self.config["samples_per_pixel"])
        self.camera = Camera(**self.config["camera"], samples_per_pixel=self.spp,
                             max_depth=int(self.config["max_depth"]),
                             light_bias=float(self.config["light_bias"]))
        self.scene = models.build(self.config["scene"])
        self.marks.append(("scene", time.perf_counter()))
        self.n_pixels = self.camera.image_width * self.camera.image_height
        shards = int(self.config.get("shards", 1))
        self.mesh = None
        if shards > 1:
            from rust_raytracer_torch.parallel import mesh as pmesh
            self.mesh = (pmesh.make_mesh(shards) if self.device.type == "cuda"
                         else pmesh.make_mesh(shards, device="cpu"))
        self.devices = (tuple(self.mesh.devices) if self.mesh is not None
                        and self.device.type == "cuda" else (self.device,))
        self.rows = check_rows(self.seed, self.n_pixels, int(self.traffic["check_pixels"])) \
            if "check_pixels" in self.traffic else None
        self.answers: Dict[str, list] = {"values": [], "seeds": [], "steps": []}
        getattr(self, "_setup_" + self.loop)()
        self.marks.append(("program", time.perf_counter()))

    # ---------------------------------------------------------- renders

    def _renderer(self):
        from rust_raytracer_torch.render.renderer import Renderer
        return Renderer(self.scene, self.camera, seed=self.run_seed,
                        batch_size=int(self.config["lanes"]),
                        kernel=self.traffic["kernel"], device=self.device, mesh=self.mesh)

    def _setup_renders(self):
        self.renderer = self._renderer()

    def _unit_renders(self, k: int) -> Unit:
        from rust_raytracer_torch.utils.metrics import RenderMetrics

        counters = RenderMetrics(n_pixels=self.n_pixels, spp=self.spp,
                                 max_depth=self.camera.max_depth)
        t0 = time.perf_counter()
        with torch.profiler.record_function("perfbench.render"):
            film = self.renderer.render(mode="pool", metrics=counters)
        _sync(self.devices)
        t1 = time.perf_counter()
        img = film.accum.reshape(-1, 3)
        self.answers["values"].append(img[self.rows])
        self.answers["seeds"].append(self.run_seed)
        return Unit(t0, t1, self.n_pixels * self.spp, bool(np.isfinite(img).all()), counters)

    # ---------------------------------------------------------- grad steps

    def _setup_grad_steps(self):
        from rust_raytracer_torch.core import rng as vrng
        from rust_raytracer_torch.render import graphs, integrator
        from rust_raytracer_torch.scene import compiler

        self.pack, static = compiler.compile_scene(self.scene, self.device)
        self.lanes = int(self.traffic["lanes"])
        cam, w = self.camera, self.camera.image_width
        depth, remat, kernel = cam.max_depth, self.traffic["remat"], self.traffic["kernel"]

        def loss(pack, px, py, smp, target, seed):
            ctx = vrng.Ctx(pixel=py * w + px, sample=smp, bounce=0, seed=seed)
            org, dirn = cam.generate_rays(px, py, smp, ctx)
            rad = integrator.trace(pack, static, org, dirn, ctx, depth, cam.light_bias,
                                   compact=False, differentiable=True, kernel=kernel,
                                   remat=remat)
            return ((rad - target) ** 2).mean()

        if self.device.type == "cuda":
            self.step = graphs.GraphedGrad(loss)
        else:
            self.step = lambda pack, *lanes: graphs.value_and_grad(loss, pack.with_grad(),
                                                                   *lanes)
        self.target = target_image(self.seed, self.n_pixels, self.device)
        self.seed_t = torch.tensor(self.run_seed, dtype=torch.int64, device=self.device)

    def _unit_grad_steps(self, k: int) -> Unit:
        w = self.camera.image_width
        pix, smp, target = step_inputs(self.seed, k, self.lanes, self.target)
        t0 = time.perf_counter()
        with torch.profiler.record_function("perfbench.grad_step"):
            loss, grads = self.step(self.pack, pix % w, pix // w, smp, target, self.seed_t)
        _sync(self.devices)
        t1 = time.perf_counter()
        finite = bool(torch.isfinite(loss))
        if k < int(self.traffic["check_steps"]):
            names = self.pack.float_fields()
            norms = torch.stack([g.double().norm() for g in grads]).cpu().tolist()
            self.answers["steps"].append({"step": k, "loss": float(loss),
                                          "norms": dict(zip(names, norms)),
                                          "inputs": (pix.cpu(), smp.cpu(), target.cpu())})
        return Unit(t0, t1, self.lanes, finite)

    # ---------------------------------------------------------- the run

    def unit(self, k: int) -> Unit:
        return getattr(self, "_unit_" + self.loop)(k)

    def peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        return max(torch.cuda.max_memory_allocated(d) for d in self.devices)

    def run(self, seconds: float, trace: bool, t_process: float) -> Outcome:
        """Set-up's remaining units (`warm_units`), then the window; with
        `trace`, its first `trace_units` units under the profiler."""
        k = 0
        for _ in range(int(self.traffic.get("warm_units", 1))):
            self.unit(k)
            k += 1
        _sync(self.devices)
        self.marks.append(("warm", time.perf_counter()))
        setup_built = library_stamps() != self.stamps
        setup_parts = {name: b - a for (_, a), (name, b) in
                       zip([("", t_process)] + self.marks, self.marks)}
        setup_peak = self.peak_bytes()
        if self.device.type == "cuda":
            for d in self.devices:
                torch.cuda.reset_peak_memory_stats(d)
        prof, traced = None, []
        t_window = time.perf_counter()
        setup_s = t_window - t_process
        units: List[Unit] = []
        if trace:
            from torch.profiler import ProfilerActivity, profile

            from perfbench.core.spans import layer_spans

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if self.device.type == "cuda" else [])
            with profile(activities=acts) as prof, layer_spans():
                with torch.profiler.record_function(TRACE_SPAN):
                    for _ in range(int(self.traffic["trace_units"])):
                        traced.append(self.unit(k))
                        k += 1
                    _sync(self.devices)
            units += traced
        while not units or units[-1].end - t_window < seconds:
            units.append(self.unit(k))
            k += 1
        window_s = units[-1].end - t_window
        window_peak = self.peak_bytes()
        dev_trace = None
        if prof is not None:
            from perfbench.core import devtrace
            idx = [d.index if d.index is not None else 0 for d in self.devices]
            dev_trace = devtrace.from_profile(prof, TRACE_SPAN, idx)
        return Outcome(units=units, setup_s=setup_s, setup_parts=setup_parts,
                       setup_built=setup_built, window_s=window_s, devices=self.devices,
                       memory_peak_bytes=max(setup_peak, window_peak),
                       window_peak_bytes=window_peak, trace=dev_trace, traced_units=traced,
                       answers=self.answers, sizes=self.sizes())

    def sizes(self) -> dict:
        """What the metrics' byte rules and counters read: the scene's
        triangles and the pool's lanes."""
        return {"triangles": self.scene_triangles(), "lanes": int(self.config.get("lanes", 0))}

    def scene_triangles(self) -> int:
        """The scene's triangles, without the BVH's padding rows."""
        pack = self.pack if hasattr(self, "pack") else self.renderer.pack
        return int((pack.tri_attr[:, 3:9].abs().sum(1) > 0).sum())

    def release(self):
        """Drop the program's state (renderer, graphs, pack) before the
        reference runs."""
        for name in ("renderer", "pack", "step", "target", "seed_t"):
            self.__dict__.pop(name, None)
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
