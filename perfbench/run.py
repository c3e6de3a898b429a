"""The benchmark of rust_raytracer_torch, one run of one cell:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in BENCHMARK.json (perfbench/core/spec.py), builds the
program's side from the cell's configuration and traffic mix
(perfbench/core/workload.py), warms it up (set-up), runs units of work for
`--seconds` (the window), then frees the program's state and holds the
outputs it kept against the plain reference (perfbench/core/check.py).
Prints the numbers compared, each beside its limit, as the last lines of
standard error, and one JSON line as the last line of standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1, each read by
perfbench/metrics/<name>.py), `device`, with --trace 1 `breakdown`,
`setup_built` (whether set-up built a library: a checkout's first run),
`setup_parts` (set-up's seconds by part) and last `checks`.

Needs CUDA and as many cards as the cell asks for: without them it exits
non-zero and prints no result.  Builds and caches stay inside the
checkout (build/).  No module of JAX or of the JAX package may be loaded
when the window has closed: the run then fails without a result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the program, inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "rust_raytracer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({name for name, mod in list(sys.modules.items())
                   if mod is not None and name.split(".")[0] in FORBIDDEN})


class MetricContext:
    """What a metric reader (perfbench/metrics/<name>.py) reads: the
    window's units and the traced ones, their seconds, the device trace
    (None unless --trace 1), the set-up's seconds, the peak memory of the
    window, the sizes of the cell (pixels, spp, triangles, lanes, shards)
    and the cell itself."""

    def __init__(self, cell, outcome):
        self.cell = cell
        self.units = outcome.units
        self.traced_units = outcome.traced_units
        self.window_s = outcome.window_s
        self.setup_s = outcome.setup_s
        self.trace = outcome.trace
        self.window_peak_bytes = outcome.window_peak_bytes
        self.sizes = outcome.sizes


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_process: float = T_PROCESS) -> dict:
    """One run of `cell` on `device`: the result's dict (without printing)."""
    import torch

    from perfbench.core import check, spec, workload

    runner = workload.Runner(cell, seed, device)
    outcome = runner.run(seconds, trace, t_process)
    ctx = MetricContext(cell, outcome)
    metrics = spec.read_metrics(cell.per_layer if trace else cell.end_to_end, ctx, cell.root)
    dev = outcome.devices[0]
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": len(outcome.devices),
        "memory_peak_bytes": int(outcome.memory_peak_bytes),
    }
    result = {"correct": False, "attempted": len(outcome.units),
              "failed": sum(not u.finite for u in outcome.units), "metrics": metrics,
              "device": device_info}
    if trace:
        device_info["busy_s"] = outcome.trace.mean_busy_s()
        device_info["window_s"] = outcome.trace.window_s
        result["breakdown"] = {"device_ops": outcome.trace.top_ops(10),
                               "idle_gaps": outcome.trace.idle_gaps(10)}
    runner.release()
    numbers = check.compare(cell, outcome.answers, runner.run_seed, runner.rows, runner.spp,
                            dev)
    ok, checks = check.verdict(numbers, cell.limits)
    result["correct"] = ok and result["failed"] == 0
    result["setup_built"] = outcome.setup_built
    result["setup_parts"] = outcome.setup_parts
    result["checks"] = checks
    secs = [u.end - u.start for u in outcome.units]
    mean = sum(secs) / len(secs)
    sd = (sum((x - mean) ** 2 for x in secs) / max(len(secs) - 1, 1)) ** 0.5
    result["recorded"] = {k: v for k, v in numbers.items() if k.startswith("worst_")}
    result["recorded"].update(unit_s_mean=mean, unit_s_sd=sd, unit_s_max=max(secs))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.core import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 1
    notes, line = result_lines(result)
    print("\n".join(notes), file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


def result_lines(result: dict) -> tuple:
    """(the last lines for standard error: each number compared beside its
    limit; the result's JSON line, its `checks` key last)."""
    result = dict(result)
    recorded = result.pop("recorded")
    checks = result.pop("checks")
    result["checks"] = checks
    notes = [f"perfbench: {name} {v!r} (recorded, not compared)" for name, v in recorded.items()]
    notes += [f"perfbench check: {name} {c['value']!r} limit {c['limit']!r}"
              for name, c in checks.items()]
    return notes, json.dumps(result)


if __name__ == "__main__":
    sys.exit(main())
