"""The planted faults of a render cell at the cell's own size: the plain
reference (perfbench/reference/) with a fault planted stands in the
program's place, against the sound reference, on the inputs a run of each
seed makes (its 4096 sampled pixels, its renders' seed, the cell's
samples a pixel).

    python3 scripts/render_faults.py --workload smoke_render --seeds 11 12 13 [--smallest]
    python3 scripts/render_faults.py --workload monkey_render --seeds 11 12 13
    python3 scripts/render_faults.py ... --device cpu --width 24    # a rehearsal

smoke_render: "density" (each volume's density off by `--offset`, default
1%), "one_stream" (both volumes draw from stream VOLUME), "second_dropped"
(the second volume left out), "cosine" (isotropic scattering replaced by
cosine scattering about the stored normal); with --smallest, also the
density offsets of 3e-3 down to 1e-6.  monkey_render: "glass_ior" (the
glass at IOR 1.4 in place of 1.5), "sun_dropped" (the sun left out of the
light list), "aperture_off" (a pinhole camera in place of the f/2.8
lens), "albedo_swapped" (the albedos of the glossy sphere nearest the
camera and of the glossy sphere whose albedo is farthest from its own
swapped; tests/test_torch_monkey_cell.py plants the same pair in the
program).  Prints one JSON line a seed and fault: the numbers compared,
each beside its limit, and whether the comparison called the fault
correct.  --width cuts the image.  Needs CUDA unless --device cpu.
"""
import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def swapped_materials(scene, position):
    """(material of the glossy sphere nearest `position`, the glossy
    material whose albedo is farthest from its own) in the reference's
    tables."""
    from perfbench.reference import tables

    mats = scene.sph_mat.long()
    glossy = (scene.mat_type[mats] == tables.MAT_GLOSSY).cpu().numpy()
    centers = scene.sph_center.cpu().numpy()
    d = np.linalg.norm(centers - np.asarray(position, np.float32), axis=1)
    near = int(mats[int(np.argmin(np.where(glossy, d, np.inf)))])
    albedo = scene.tex_const[scene.mat_albedo_tex.long()].cpu().numpy()
    gap = np.linalg.norm(albedo - albedo[near], axis=1)
    gap[(scene.mat_type != tables.MAT_GLOSSY).cpu().numpy()] = -1.0
    return near, int(np.argmax(gap))


def faulted(ref, cell, fault: str, offset: float):
    """A copy of the Reference `ref` with `fault` planted in its tables or
    camera (the stream fault is planted around the call, in `sums`)."""
    from perfbench.core import check
    from perfbench.reference import tables

    out = object.__new__(check.Reference)
    out.__dict__.update(ref.__dict__)
    s = ref.scene
    if fault == "density":
        out.scene = s.with_tables(vol_neg_inv_density=s.vol_neg_inv_density / (1.0 + offset))
    elif fault == "second_dropped":
        out.scene = s.with_tables(**{k: s.tensors[k][:1] for k in (
            "vol_center", "vol_axes", "vol_halfsize", "vol_neg_inv_density", "vol_mat",
            "vol_kind")})
    elif fault == "cosine":
        mtype = s.mat_type.clone()
        mtype[s.vol_mat.long()] = tables.MAT_LAMBERTIAN
        out.scene = s.with_tables(mat_type=mtype)
    elif fault == "glass_ior":
        glass = s.mat_type == tables.MAT_DIELECTRIC
        out.scene = s.with_tables(mat_ior=s.mat_ior.masked_fill(glass, 1.4))
    elif fault == "sun_dropped":
        out.scene = dataclasses.replace(s, light_list=tuple(
            e for e in s.light_list if e[0] != tables.LIGHT_SUN))
    elif fault == "aperture_off":
        out.camera = dataclasses.replace(ref.camera, f_number=None)
    elif fault == "albedo_swapped":
        a, b = swapped_materials(s, cell.config["camera"]["position"])
        alb = s.mat_albedo_tex.clone()
        alb[a], alb[b] = s.mat_albedo_tex[b], s.mat_albedo_tex[a]
        out.scene = s.with_tables(mat_albedo_tex=alb)
    return out


@contextlib.contextmanager
def one_stream():
    """Both volumes draw from stream VOLUME."""
    from perfbench.reference import rng, volumes

    orig = volumes.volume_stream
    volumes.volume_stream = lambda vi: rng.Streams.VOLUME
    try:
        yield
    finally:
        volumes.volume_stream = orig


FAULTS = {
    "smoke_render": ("density", "one_stream", "second_dropped", "cosine"),
    "monkey_render": ("glass_ior", "sun_dropped", "aperture_off", "albedo_swapped"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--offset", type=float, default=0.01)
    ap.add_argument("--smallest", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from perfbench import control
    from perfbench.core import check, spec

    if args.device == "cuda" and not torch.cuda.is_available():
        print("render_faults: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    if args.width:
        cell.config["camera"]["image_width"] = args.width
    dev = torch.device(args.device)
    cases = [(f, args.offset) for f in FAULTS[args.workload]]
    if args.smallest and "density" in FAULTS[args.workload]:
        cases += [("density", x) for x in (3e-3, 1e-3, 3e-4, 1e-4, 1e-5, 1e-6)]
    for seed in args.seeds:
        answers, run_seed, rows, spp = control.run_inputs(cell, seed, dev)
        ref = check.Reference(cell, dev, spp)
        want = ref.pixel_sums(rows, answers["seeds"], spp)
        for fault, offset in cases:
            with one_stream() if fault == "one_stream" else contextlib.nullcontext():
                got = faulted(ref, cell, fault, offset).pixel_sums(rows, answers["seeds"], spp)
            numbers = check.pixel_mismatch(got, want)
            ok, checks = check.verdict(numbers, cell.limits)
            print(json.dumps({"workload": cell.name, "seed": seed, "fault": fault,
                              "offset": offset if fault == "density" else None,
                              "fault_correct": ok, "numbers": numbers, "checks": checks}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
