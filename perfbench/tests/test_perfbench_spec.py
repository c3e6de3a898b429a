"""BENCHMARK.json against the benchmark's contract, and discovery of
configurations, traffic mixes and metrics from their files."""
import json
import re
import shutil

import pytest

from perfbench.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion)|(_dim|_rank)$")

BENCH = spec.load_benchmark()


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    # a full check: 2 + 14 x cells runs of run_seconds + 60 s, 180 s of compile a cell,
    # 1200 s spare, within 43200 s even at the 24 cells later PRs may reach
    full = 2 + 14 * 24
    assert full * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= n <= 24


def test_entries_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == want, e
            assert NAME.match(e["name"]), e["name"]
    for c in BENCH["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("perfbench/")
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert all(k in cfg for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_from_its_files(workload):
    """Each cell's configuration, traffic, metric readers and limits come
    from files found by name; it reports setup_s, another end-to-end metric
    and a per-layer metric, and each per-layer metric moves one of its
    end-to-end metrics."""
    cell = spec.load_cell(workload)
    assert cell.traffic["loop"] in ("renders", "grad_steps")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert cell.limits, "every cell's comparison has its limits"
    spec.scene_module(cell.config["scene"])


def test_dummy_cell_from_files_alone(tmp_path, monkeypatch):
    """A new cell, traffic mix and metric are added by new files and new
    entries only: a copy of the benchmark gains them, and a run of the new
    cell (at a tiny size, on the CPU) reports the new metric."""
    from perfbench.tests.small import small_cell
    import perfbench.run as run

    shutil.copytree(spec.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy_render", "config": "cornell_dragon",
                               "traffic": "dummy_offline", "chips": 1, "why": "test"})
    bench["end_to_end"][0].setdefault("workloads", []).append("dummy_render")
    bench["per_layer"].append({"name": "dummy_renders", "unit": "renders", "better": "higher",
                               "source": "host_clock", "layer": "Pool loop",
                               "moves": bench["end_to_end"][0]["name"],
                               "workloads": ["dummy_render"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((spec.ROOT / "perfbench/traffic/offline_16spp.json").read_text())
    (tmp_path / "perfbench/traffic/dummy_offline.json").write_text(json.dumps(traffic))
    (tmp_path / "perfbench/metrics/dummy_renders.py").write_text(
        "def read(ctx):\n    return len(ctx.traced_units)\n")
    (tmp_path / "perfbench/limits/dummy_render.json").write_text(
        (spec.ROOT / "perfbench/limits/dragon_render.json").read_text())
    cell = small_cell("dummy_render", monkeypatch, root=tmp_path)
    assert cell.root == tmp_path
    assert [m["name"] for m in cell.per_layer] == ["dummy_renders"]
    res = run.run_cell(cell, 12345, 0.2, True, device="cpu")
    assert res["metrics"] == {"dummy_renders": {"value": 1.0, "unit": "renders"}}
    assert res["correct"] is True
    notes, line = run.result_lines(res)
    last = json.loads(line)
    assert list(last) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "setup_built", "setup_parts", "checks"]
    assert isinstance(last["setup_built"], bool)
    assert list(last["setup_parts"]) == ["imports", "kernels", "scene", "program", "warm"]
    assert sum(last["setup_parts"].values()) <= res["metrics"].get("setup_s", {}).get(
        "value", float("inf"))
    assert set(last["device"]) == {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
                                   "window_s"}
    assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    assert notes[-1].startswith("perfbench check: pixel_mismatch_share 0.0 limit ")
