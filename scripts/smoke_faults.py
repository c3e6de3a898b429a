"""The planted faults of the `smoke_render` cell at the cell's own size:
the plain reference (perfbench/reference/) with a fault planted stands in
the program's place, against the sound reference, on the inputs a run of
each seed makes (its 4096 sampled pixels, its renders' seed, 225 samples).

    python3 scripts/smoke_faults.py --seeds 11 12 13 [--device cpu]

Faults: "density" (each volume's density off by `--offset`, default 1%),
"one_stream" (both volumes draw from stream VOLUME), "second_dropped" (the
second volume left out), "cosine" (isotropic scattering replaced by cosine
scattering about the stored normal).  With --smallest, also the density
offsets of 1e-2 down to 1e-6 that still fail the limit.  Prints one JSON
line a seed and fault: the numbers compared, each beside its limit, and
whether the comparison called the fault correct.  Needs CUDA unless
--device cpu.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FAULTS = ("density", "one_stream", "second_dropped", "cosine")


def faulted(ref, fault: str, offset: float):
    """A copy of the Reference `ref` with `fault` planted in its tables (the
    stream fault is planted around the call, in `sums`)."""
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
    return out


def sums(ref, fault: str, rows, seeds, spp):
    from perfbench.reference import rng, volumes

    if fault != "one_stream":
        return ref.pixel_sums(rows, seeds, spp)
    orig = volumes.volume_stream
    volumes.volume_stream = lambda vi: rng.Streams.VOLUME
    try:
        return ref.pixel_sums(rows, seeds, spp)
    finally:
        volumes.volume_stream = orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--offset", type=float, default=0.01)
    ap.add_argument("--smallest", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from perfbench import control
    from perfbench.core import check, spec

    if args.device == "cuda" and not torch.cuda.is_available():
        print("smoke_faults: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell("smoke_render")
    dev = torch.device(args.device)
    cases = [(f, args.offset) for f in FAULTS]
    if args.smallest:
        cases += [("density", x) for x in (3e-3, 1e-3, 3e-4, 1e-4, 1e-5, 1e-6)]
    for seed in args.seeds:
        answers, run_seed, rows, spp = control.run_inputs(cell, seed, dev)
        ref = check.Reference(cell, dev, spp)
        want = ref.pixel_sums(rows, answers["seeds"], spp)
        for fault, offset in cases:
            got = sums(faulted(ref, fault, offset), fault, rows, answers["seeds"], spp)
            numbers = check.pixel_mismatch(got, want)
            ok, checks = check.verdict(numbers, cell.limits)
            print(json.dumps({"workload": cell.name, "seed": seed, "fault": fault,
                              "offset": offset if fault == "density" else None,
                              "fault_correct": ok, "numbers": numbers, "checks": checks}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
