"""Hold KV2, the shading kernel (csrc/vertex_shade.cu via
ops/vertex.py:shade_hits), which evaluates only the texture closure of a
lane's shading key, against the plain shading and against another
checkout's KV2 on the same lanes, on the card, and time it in turns.

    python3 scripts/kv2_closure_check.py --other chipcheck/parent   # on the GPU, ~3 min
    python3 scripts/kv2_closure_check.py --device cpu --small       # a rehearsal on the CPU

Records the eager pool steps of a 1-spp render at 2^18 lanes of three
scenes: golden_monkey at 1200x800 with its f/2.8 aperture (838 texture
nodes, 418 materials, sky and sun), cornell_dragon at 1200x1200 and
cornell_smoke at 600x600.  On each picked step (golden_monkey's first,
mid-render and drain steps; the others' mid step) it makes KV2's inputs
the way the pool step makes them (the plain KV1 hits, the walk's, and in
a scene with volumes the plain merge) and holds this checkout's KV2
against the plain version (ops/intersect.py:close_hits, then
render/integrator.py:shade_hits): every output bit for bit (NaN = NaN);
on golden_monkey also KV2's sphere-hit counter against the plain hits'
count.  Then KV2 of --other, of this checkout, of this checkout, of
--other, each in a process of its own (this script with --worker) that
builds its package's kernels and scene, runs its KV2 on the saved inputs
and times it (CUDA events around one replay of a graph of --reps calls);
every run's outputs must equal the first's bit for bit.  A checkout whose
tables refuse a scene (before the closure table, a program of more than
32 nodes) is recorded as refusing it.  Prints the card's name and power
limit, a line a set, and one JSON line of the times.  Keeps the inputs and
the runs' outputs under build/kv2_closure/.

On the CPU (--device cpu) the plain shading stands in for KV2 (there is no
kernel), so a rehearsal checks the plumbing, not the kernel; --small cuts
the images and the pool.
"""
import argparse
import json
import os
import sys
import time

sys.modules["jax"] = None  # the port runs without JAX

import torch  # noqa: E402

from in_turns import (build, card, pick, record, run_in_turns,  # noqa: E402
                      this_over_other, time_graphed_ms, unequal)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "kv2_closure")
LANES, SMALL_LANES = 1 << 18, 2048
# scene: image width (each keeps its own camera: golden_monkey's aperture)
SCENES = {"golden_monkey": 1200, "cornell_dragon": 1200, "cornell_smoke": 600}
OUTPUTS = ("emission", "weight", "new_dir", "ended", "pos")


def log(*a):
    print(*a, flush=True)


def kv2_inputs(pack, s):
    """KV2's inputs on pool-step state `s`, as the pool step makes them:
    {org, dirn, pixel, sample, bounce, active, hits, merged}."""
    from rust_raytracer_torch.core import rng as vrng
    from rust_raytracer_torch.ops import intersect as isect
    from rust_raytracer_torch.render import integrator

    n = s.org.shape[0]
    ctx = vrng.Ctx(pixel=s.pixel, sample=s.sample, bounce=s.bounce, seed=0)
    tl = torch.full((n,), integrator.T_MIN, dtype=torch.float32, device=s.org.device)
    with torch.no_grad():
        hits = isect.analytic_hits(pack, s.org, s.dirn, tl, s.active)
        t_tri, i_tri = isect.intersect_triangles(pack, s.org, s.dirn, integrator.T_MIN, hits[4],
                                                 kernel="auto")
        hits = (*hits[:4], t_tri.contiguous(), i_tri.contiguous())
        merged = (isect.merge_volumes(pack, s.org, s.dirn, tl, ctx, *hits)
                  if pack.vol_kinds else None)
    return {"org": s.org.contiguous(), "dirn": s.dirn.contiguous(), "pixel": s.pixel,
            "sample": s.sample, "bounce": s.bounce, "active": s.active, "hits": hits,
            "merged": None if merged is None else tuple(merged)}


def ctx_of(inp):
    from rust_raytracer_torch.core import rng as vrng

    return vrng.Ctx(pixel=inp["pixel"], sample=inp["sample"], bounce=inp["bounce"], seed=0)


def kv2(pack, static, inp, light_bias, **counters):
    """KV2 of the imported package on `inp` (its plain version on the CPU)."""
    from rust_raytracer_torch.ops import vertex

    if inp["org"].device.type == "cpu":
        return plain(pack, static, inp, light_bias)[0]
    return vertex.shade_hits(pack, static, inp["org"], inp["dirn"], ctx_of(inp), light_bias,
                             inp["hits"], inp["merged"], **counters)


def plain(pack, static, inp, light_bias):
    """The plain shading on `inp`: close_hits, then integrator.shade_hits."""
    from rust_raytracer_torch.ops import intersect as isect
    from rust_raytracer_torch.render import integrator

    n = inp["org"].shape[0]
    tl = torch.full((n,), integrator.T_MIN, dtype=torch.float32, device=inp["org"].device)
    with torch.no_grad():
        hit = isect.close_hits(pack, inp["org"], inp["dirn"], tl, ctx_of(inp), *inp["hits"])
        return integrator.shade_hits(pack, static, inp["org"], inp["dirn"], hit, ctx_of(inp),
                                     light_bias), hit


def worker(args):
    """KV2 of the package at --worker on the saved inputs: its outputs and
    ms a set, or the error its tables raised."""
    sys.path.insert(0, os.path.abspath(args.worker))
    from rust_raytracer_torch.ops import _cuda, vertex

    dev = torch.device(args.device)
    if dev.type == "cuda":
        _cuda.build_library()
    saved = torch.load(args.inputs, map_location=dev)
    out = {"root": os.path.abspath(args.worker)}
    for name in SCENES:
        try:
            pack, static, camera = build(name, SCENES[name], args.small, dev)
            if dev.type == "cuda":
                vertex.tables(pack, static)
        except Exception as e:  # noqa: BLE001 - a checkout that cannot build a scene is recorded
            out[name] = {"refused": repr(e)}
            continue
        out[name] = {}
        for tag, inp in saved[name].items():
            got = kv2(pack, static, inp, camera.light_bias)
            ms = time_graphed_ms(lambda: kv2(pack, static, inp, camera.light_bias), args.reps,
                                 dev)
            out[name][tag] = {"out": tuple(x.cpu() for x in got), "ms": ms}
        del pack
    torch.save(out, args.out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another checkout of this repo (its KV2 is held equal)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("kv2_closure_check: torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    from rust_raytracer_torch.ops import _cuda, vertex
    from rust_raytracer_torch.scene import pack as sp

    log(f"card: {card()}")
    if dev.type == "cuda":
        _cuda.build_library()
        log(f"vertex_shade_kernel: {_cuda.attributes('rrt_vertex_shade')}")
    lanes = SMALL_LANES if args.small else LANES
    saved, result = {}, {"card": card(), "sets": {}}
    for name in SCENES:
        t0 = time.perf_counter()
        pack, static, camera = build(name, SCENES[name], args.small, dev)
        states = record(pack, static, camera, lanes)
        closures = vertex.texture_closures(
            static.tex_program, *(getattr(pack, f).cpu().numpy() for f in (
                "mat_albedo_tex", "mat_rough_tex", "mat_normal_tex", "sky_tex", "sun_tex")))
        log(f"{name}: {camera.image_width}x{camera.image_height}, {len(states)} steps recorded "
            f"({time.perf_counter() - t0:.1f} s); {len(static.tex_program)} texture nodes, "
            f"{len(closures)} closures, the longest {max(len(c[0]) for c in closures)} nodes")
        saved[name] = {}
        for tag, s in pick(states, name == "golden_monkey"):
            inp = kv2_inputs(pack, s)
            counters = {}
            if dev.type == "cuda" and pack.sph_center.shape[0]:
                counters["sphere_hits"] = torch.zeros(vertex.VOLUME_SLOTS, dtype=torch.int64,
                                                      device=dev)
                counters["alive"] = inp["active"]
            got = kv2(pack, static, inp, camera.light_bias, **counters)
            want, hit = plain(pack, static, inp, camera.light_bias)
            bad = {o: unequal(a, b) for o, a, b in zip(OUTPUTS, got, want)}
            line = {"lanes not bit-equal": bad, "live": int(inp["active"].sum())}
            if "sphere_hits" in counters:
                plain_count = int(((hit.kind == sp.PRIM_SPHERE) & inp["active"]).sum())
                line["sphere hits (KV2, plain)"] = (int(counters["sphere_hits"].sum()),
                                                    plain_count)
                if line["sphere hits (KV2, plain)"][0] != plain_count:
                    raise AssertionError(f"{name} {tag}: KV2's sphere count differs: {line}")
            kinds = torch.bincount(hit.kind.long(), minlength=7).tolist()
            line["hit kinds (none sphere plane triangle volume sky sun)"] = kinds
            log(f"{name} {tag}: KV2 vs plain: {json.dumps(line)}")
            if any(bad.values()):
                raise AssertionError(f"{name} {tag}: KV2 differs from the plain shading: {bad}")
            saved[name][tag] = {k: (tuple(x.cpu() for x in v) if isinstance(v, tuple)
                                    else v.cpu()) if v is not None else None
                                for k, v in inp.items()}
            result["sets"][f"{name} {tag}"] = line
        del states, pack
    os.makedirs(OUT, exist_ok=True)
    torch.save(saved, os.path.join(OUT, "inputs.pt"))

    runs = run_in_turns(__file__, HERE, args.other, OUT,
                        ["--inputs", os.path.join(OUT, "inputs.pt"), "--device", args.device,
                         "--reps", str(args.reps)] + (["--small"] if args.small else []))
    first = {name: next((r[name] for _, r in runs if "refused" not in r[name]), None)
             for name in SCENES}
    for side, run in runs:
        for name in SCENES:
            if "refused" in run[name]:
                log(f"{side} ({run['root']}) refuses {name}: {run[name]['refused']}")
                continue
            for tag, rec in run[name].items():
                bad = [unequal(a, b) for a, b in zip(rec["out"], first[name][tag]["out"])]
                if any(bad):
                    raise AssertionError(f"{name} {tag}: {side} ({run['root']}) differs from "
                                         f"the first run: {dict(zip(OUTPUTS, bad))}")
    for name in SCENES:
        for tag in saved[name]:
            ms = {}
            for side, run in runs:
                if "refused" not in run[name]:
                    ms.setdefault(side, []).append(run[name][tag]["ms"])
            key = f"{name} {tag}"
            result["sets"][key]["ms"] = ms
            if "other" in ms and "this" in ms:
                result["sets"][key]["this_over_other"] = this_over_other(ms)
            log(f"time KV2 {key}: {json.dumps(ms)} ms (a graph of {args.reps} calls, CUDA "
                f"events); the outputs of every run equal bit for bit")
    log(json.dumps(result))


if __name__ == "__main__":
    main()
