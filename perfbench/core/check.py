"""How `correct` is decided: the program's outputs against the plain
reference (perfbench/reference/), which works out its scene, its hits and
its paths itself from the configuration and the inputs the harness makes.

Renders: for the pixels `workload.check_rows` draws from the
seed, each unit's radiance sums on the host against the reference's sums
of the same samples (same pixel, sample ids and seed, so the same paths).
The number compared is `pixel_mismatch_share`: the share of (unit, pixel)
pairs whose gap, max over channels |program - reference| over the larger
of the reference pixel's magnitude and a tenth of the sampled pixels' mean
magnitude, exceeds PIXEL_TOL.  Float order alone moves a pixel by ~1e-7;
a path that takes another way (an ulp-driven flip) moves it by O(1).

Grad steps: the first `check_steps` steps (set-up's, through the window's
own call) against the reference's fwd+bwd of the same lanes:
`loss_gap`, the largest relative gap of a step's loss, and
`grad_norm_gap`, the largest gap between the program's and the
reference's norm of one table's gradient, over the larger of the
reference's norm of that table and the median table's.  A table whose
reference gradient is under GRAD_FLOOR of the median table's counts only
where the program moves it by more than that.

Each number has its limit in perfbench/limits/<workload>.json; a number
without a limit is not correct.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench.core import spec

PIXEL_TOL = 1e-4
GRAD_FLOOR = 1e-3
LANE_BLOCK = 1 << 16


class Reference:
    """The reference's scene, triangle search and camera for a cell."""

    def __init__(self, cell, device, spp: int):
        from perfbench.reference import camera as rcam
        from perfbench.reference import hits, tables

        cfg = cell.config
        built = spec.scene_module(cfg["scene"]).build(cfg)
        self.scene = tables.build(built, device)
        self.search = hits.TriangleSearch(self.scene.tri_rows)
        self.camera = rcam.Camera(**cfg["camera"], samples_per_pixel=spp,
                                  max_depth=int(cfg["max_depth"]),
                                  light_bias=float(cfg["light_bias"]))
        self.device = torch.device(device)

    def rounded(self, rounding: Optional[Callable]) -> "Reference":
        """This reference with its float tables passed through `rounding`
        (the control's lower precision)."""
        if rounding is None:
            return self
        from perfbench.reference import hits

        out = object.__new__(Reference)
        out.__dict__.update(self.__dict__)
        out.scene = self.scene.with_tables(**{k: rounding(v) for k, v in
                                              self.scene.tensors.items()
                                              if v.is_floating_point()})
        out.search = hits.TriangleSearch(out.scene.tri_rows)
        return out

    def pixel_sums(self, rows: np.ndarray, seeds: List[int], spp: int,
                   rounding: Optional[Callable] = None) -> np.ndarray:
        """(len(seeds), len(rows), 3) float64 radiance sums of `spp` samples
        (ids 0..spp-1) of pixels `rows` under each seed."""
        from perfbench.reference import trace

        ref = self.rounded(rounding)
        uniq = sorted(set(seeds))
        k, w = len(rows), self.camera.image_width
        dev = self.device
        pix = torch.as_tensor(rows, dtype=torch.int64, device=dev).repeat_interleave(spp)
        smp = torch.arange(spp, device=dev).repeat(k)
        lanes_px = pix.repeat(len(uniq))
        lanes_smp = smp.repeat(len(uniq))
        lanes_seed = torch.as_tensor(uniq, dtype=torch.int64, device=dev).repeat_interleave(k * spp)
        out = torch.empty((lanes_px.shape[0], 3), dtype=torch.float32, device=dev)
        for a in range(0, lanes_px.shape[0], LANE_BLOCK):
            b = a + LANE_BLOCK
            p = lanes_px[a:b]
            out[a:b] = trace.radiance(ref.scene, ref.search, ref.camera, p % w, p // w,
                                      lanes_smp[a:b], lanes_seed[a:b],
                                      self.camera.max_depth, rounding)
        sums = out.double().reshape(len(uniq), k, spp, 3).sum(2).cpu().numpy()
        at = {s: i for i, s in enumerate(uniq)}
        return np.stack([sums[at[s]] for s in seeds])

    def grad_step(self, px, py, smp, target, seed: int,
                  rounding: Optional[Callable] = None) -> dict:
        """{"loss", "norms": {table: gradient norm}} of the reference's fwd+bwd
        of one step's lanes."""
        from perfbench.reference import tables, trace

        ref = self.rounded(rounding)
        leaves = {f: ref.scene.tensors[f].detach().requires_grad_(True)
                  for f in tables.FLOAT_FIELDS}
        scene = ref.scene.with_tables(**leaves)
        rad = trace.radiance_differentiable(scene, ref.search, ref.camera, px, py, smp, seed,
                                            self.camera.max_depth, rounding)
        loss = ((rad - target) ** 2).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        norms = {f: (0.0 if g is None else float(g.double().norm()))
                 for f, g in zip(leaves, grads)}
        return {"loss": float(loss.detach()), "norms": norms}


def pixel_mismatch(program: np.ndarray, reference: np.ndarray) -> Dict[str, float]:
    """The compared number of renders, and the worst gap (for
    the record)."""
    mag = np.abs(reference).max(-1)
    scale = np.maximum(mag, 0.1 * max(float(mag.mean()), 1e-30))
    gap = np.abs(program - reference).max(-1) / scale
    gap = np.where(np.isfinite(gap), gap, np.inf)
    return {"pixel_mismatch_share": float((gap > PIXEL_TOL).mean()),
            "worst_pixel_gap": float(gap.max())}


def grad_gaps(program: List[dict], reference: List[dict]) -> Dict[str, float]:
    """The compared numbers of grad steps, over the steps both have."""
    loss_gap, norm_gap = 0.0, 0.0
    for p, r in zip(program, reference, strict=True):
        loss_gap = max(loss_gap, abs(p["loss"] - r["loss"]) / max(abs(r["loss"]), 1e-30))
        moved = [v for v in r["norms"].values() if v > 0.0]
        median = float(np.median(moved)) if moved else 0.0
        for f in set(p["norms"]) | set(r["norms"]):
            a, b = p["norms"].get(f, 0.0), r["norms"].get(f, 0.0)
            if max(a, b) < GRAD_FLOOR * median:
                continue
            gap = abs(a - b) / max(b, median, 1e-30)
            norm_gap = max(norm_gap, gap if math.isfinite(gap) else math.inf)
        if not math.isfinite(p["loss"]):
            loss_gap = math.inf
    return {"loss_gap": loss_gap, "grad_norm_gap": norm_gap}


def compare(cell, answers: dict, run_seed: int, rows, spp: int, device,
            rounding: Optional[Callable] = None) -> Dict[str, float]:
    """The numbers compared for one run: the program's `answers` (the
    sampled pixels' sums a unit and the seed of each unit, or the checked
    grad steps with their inputs) against the reference, made on `device`
    after the program's state is freed.  With `rounding`, the reference
    under it stands in the program's place: the control."""
    ref = Reference(cell, device, spp)
    if cell.traffic["loop"] == "grad_steps":
        w = ref.camera.image_width
        prog, want = [], []
        for a in answers["steps"]:
            pix, smp, target = (x.to(device) for x in a["inputs"])
            want.append(ref.grad_step(pix % w, pix // w, smp, target, run_seed))
            prog.append(a if rounding is None else
                        ref.grad_step(pix % w, pix // w, smp, target, run_seed, rounding))
        return grad_gaps(prog, want)
    seeds = answers["seeds"]
    want = ref.pixel_sums(rows, seeds, spp)
    prog = (np.stack(answers["values"]) if rounding is None
            else ref.pixel_sums(rows, seeds, spp, rounding))
    return pixel_mismatch(prog, want)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}) of the compared numbers: each
    at or under its limit; a number without a limit fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        if name.startswith("worst_"):
            continue
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and math.isfinite(value) and value <= limit
    return ok, checks
