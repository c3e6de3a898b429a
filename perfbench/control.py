"""The control of the benchmark's comparison: the plain reference put in
the program's place, with its lane state (origin, direction, throughput,
radiance) and its scene tables stored in bfloat16, the nearest precision
below the configurations' float32 (TF32 has nothing to act on: no matrix
product is on the path).  It has to come out as not correct; its readings
are the upper ends the limits in perfbench/limits/ were set below.

    python3 perfbench/control.py --workload <name> --seeds 11 12 13

For each seed it makes the inputs a run of that seed makes (the sampled
pixels and the renders' seed, or the checked grad steps' lanes and
targets), computes the reference and the control on them, and prints one
JSON line of the numbers compared with their limits.  The benchmark's own
runs never run it.  Needs CUDA, unless --device cpu.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def run_inputs(cell, seed: int, device) -> tuple:
    """(answers without the program's outputs, run seed, rows, spp) of a run
    of `cell` with `seed`, as perfbench/core/workload.py makes them."""
    from perfbench.core import workload as wl

    cam = cell.config["camera"]
    n_pixels = cam["image_width"] * max(1, int(cam["image_width"] / cam["aspect_ratio"]))
    spp = int(cell.config["samples_per_pixel"])
    run_seed = wl.derive_seed(seed, 0)
    answers = {"values": [], "seeds": [], "steps": []}
    rows = None
    if cell.traffic["loop"] == "grad_steps":
        target = wl.target_image(seed, n_pixels, device)
        for k in range(int(cell.traffic["check_steps"])):
            pix, smp, tgt = wl.step_inputs(seed, k, int(cell.traffic["lanes"]), target)
            answers["steps"].append({"step": k, "inputs": (pix, smp, tgt)})
    else:
        rows = wl.check_rows(seed, n_pixels, int(cell.traffic["check_pixels"]))
        answers["seeds"] = [run_seed]
    return answers, run_seed, rows, spp


def control_numbers(cell, seed: int, device) -> dict:
    """The compared numbers of the control on the inputs of `seed`."""
    from perfbench.core import check
    from perfbench.reference import trace

    answers, run_seed, rows, spp = run_inputs(cell, seed, device)
    return check.compare(cell, answers, run_seed, rows, spp, device,
                         rounding=trace.to_bfloat16)


def fault_numbers(cell, seed: int, device, fault: str) -> dict:
    """The compared numbers of a grad cell when the program's answers are the
    reference's with a fault planted (at the cell's own size):
    "stale", each step returns the step before's answer; "half", the loss
    and gradients of the first half of the lanes (the mean over them);
    "altered", the light's emission 10% off where it is produced."""
    from perfbench.core import check
    from perfbench.reference import tables

    answers, run_seed, _, spp = run_inputs(cell, seed, device)
    ref = check.Reference(cell, device, spp)
    w = ref.camera.image_width
    want, prog = [], []
    for a in answers["steps"]:
        pix, smp, tgt = a["inputs"]
        want.append(ref.grad_step(pix % w, pix // w, smp, tgt, run_seed))
        if fault == "half":
            h = pix.shape[0] // 2
            prog.append(ref.grad_step(pix[:h] % w, pix[:h] // w, smp[:h], tgt[:h], run_seed))
    if fault == "stale":
        prog = [want[0]] + want[:-1]
    elif fault == "altered":
        scene = ref.scene
        emissive = scene.mat_albedo_tex[scene.mat_type == tables.MAT_EMISSIVE].long()
        const = scene.tex_const.clone()
        const[emissive] *= 1.1
        ref.scene = scene.with_tables(tex_const=const)
        for a in answers["steps"]:
            pix, smp, tgt = a["inputs"]
            prog.append(ref.grad_step(pix % w, pix // w, smp, tgt, run_seed))
    return check.grad_gaps(prog, want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=("stale", "half", "altered"),
                    help="a grad cell's planted fault in place of the control")
    args = ap.parse_args(argv)
    import torch

    from perfbench.core import check, spec

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        dev = torch.device(args.device)
        numbers = (fault_numbers(cell, seed, dev, args.fault) if args.fault
                   else control_numbers(cell, seed, dev))
        ok, checks = check.verdict(numbers, cell.limits)
        print(json.dumps({"workload": cell.name, "seed": seed, "fault": args.fault,
                          "control_correct": ok,
                          "numbers": numbers, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
