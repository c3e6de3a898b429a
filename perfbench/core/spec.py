"""What a run measures, found by name in BENCHMARK.json and the files under
perfbench/: the cell (`workloads` entry), its configuration (`configs`
entry and the JSON file it names), its traffic mix
(perfbench/traffic/<traffic>.json), the metrics it reports (one reader a
metric, perfbench/metrics/<metric>.py) and the limits of its comparison
(perfbench/limits/<workload>.json).  A later cell, traffic mix or metric
is added by adding such files and entries; nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    """One cell: its entry, its configuration's entry and file, its traffic
    mix, the metrics it reports with --trace 0 (`end_to_end`) and with
    --trace 1 (`per_layer`), and its comparison's limits."""
    name: str
    chips: int
    workload: dict
    config_entry: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict
    root: Path = ROOT


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metrics_of(bench: dict, workload: str) -> tuple:
    """The end-to-end and per-layer metrics a cell reports: a metric with a
    `workloads` list is reported in those cells; an end-to-end metric
    without one in every cell; a per-layer metric without one in every
    cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


def load_cell(workload: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell named `workload`; KeyError if BENCHMARK.json has none."""
    bench = load_benchmark(root) if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"choose from {sorted(by_name)}")
    w = by_name[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e, layer = metrics_of(bench, workload)
    limits_path = root / "perfbench" / "limits" / f"{workload}.json"
    return Cell(name=workload, chips=int(w["chips"]), workload=w, config_entry=entry,
                config=_read_json(root / entry["file"]),
                traffic=_read_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=layer,
                limits=_read_json(limits_path) if limits_path.exists() else {}, root=root)


def load_module(path: Path, name: str):
    """The Python file at `path` as a module (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """`read(ctx)` of metric `name`: perfbench/metrics/<name>.py."""
    mod = load_module(root / "perfbench" / "metrics" / f"{name}.py",
                      "perfbench_metric_" + name.replace(".", "_").replace("-", "_"))
    return mod.read


def scene_module(scene: str):
    """The reference's scene module of `scene`: perfbench/scenes/<scene>.py."""
    return importlib.import_module(f"perfbench.scenes.{scene}")


def read_metrics(specs: List[dict], ctx, root: Path = ROOT) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the metrics whose reader found something
    to read (a reader returns None where it found nothing)."""
    out = {}
    for m in specs:
        value = metric_reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
