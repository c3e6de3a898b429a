"""The control (the reference with its lane state and tables in bfloat16,
in the program's place) comes out not correct under each cell's limits,
at a size a test run holds; so do a grad cell's planted faults."""
import pytest
import torch

from perfbench import control
from perfbench.core import check
from perfbench.tests.small import small_cell


@pytest.mark.parametrize("workload,shards", [("dragon_render", 1), ("dragon_render", 4),
                                             ("dragon_grad", 1)])
def test_control_is_not_correct(workload, shards, monkeypatch):
    cell = small_cell(workload, monkeypatch, shards=shards)
    numbers = control.control_numbers(cell, 2 ** 31 + 9, torch.device("cpu"))
    ok, checks = check.verdict(numbers, cell.limits)
    assert ok is False, checks


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_grad_faults_are_not_correct(fault, monkeypatch):
    cell = small_cell("dragon_grad", monkeypatch)
    numbers = control.fault_numbers(cell, 2 ** 31 + 9, torch.device("cpu"), fault)
    ok, checks = check.verdict(numbers, cell.limits)
    assert ok is False, checks
