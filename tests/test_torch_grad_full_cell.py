"""The dragon_grad_full cell (cornell_dragon, fwd+bwd steps of 2^18 lanes
under full rematerialisation) at a tiny size on the CPU: its traffic is
grad_65536's but for the lanes and the remat mode, a sound run is correct
under the cell's own limits, and each grad fault planted in the program
(a stale answer, half of the lanes, an altered emission) is not."""
import json
from pathlib import Path

import pytest

import perfbench.run as run
from perfbench.tests.small import small_cell
from perfbench.tests.test_perfbench_faults import _altered_emission, _half_lanes, _stale_grad

ROOT = Path(__file__).resolve().parent.parent
SEED = 2 ** 31 + 23


def test_traffic_is_grad_65536_at_full_remat_and_four_times_the_lanes():
    traffic = ROOT / "perfbench" / "traffic"
    full = json.loads((traffic / "grad_262144_full.json").read_text())
    base = json.loads((traffic / "grad_65536.json").read_text())
    assert (full["lanes"], full["remat"]) == (4 * base["lanes"], "full")
    same = {k for k in base if k not in ("lanes", "remat", "why")}
    assert {k: full[k] for k in same} == {k: base[k] for k in same}
    assert set(full) == set(base)


def test_sound_run_is_correct(monkeypatch):
    cell = small_cell("dragon_grad_full", monkeypatch)
    assert cell.traffic["remat"] == "full"
    res = run.run_cell(cell, SEED, 0.05, False, device="cpu")
    assert res["correct"] is True, res["checks"]


FAULTS = [_stale_grad, _half_lanes, _altered_emission]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    cell = small_cell("dragon_grad_full", monkeypatch)
    fault(monkeypatch)
    res = run.run_cell(cell, SEED, 0.05, False, device="cpu")
    assert res["correct"] is False, res["checks"]
