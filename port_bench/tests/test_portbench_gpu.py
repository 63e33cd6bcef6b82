"""On the card, at the tiny size: the program's check passes and its
control (the reference with TF32 on, in the program's place) fails the
cell's limits.  Marked ``gpu``; each test decides in its fixture whether
there is a card."""

import importlib

import pytest
import torch

from port_bench import calibrate
from port_bench.lib import compare, harness
from port_bench.tests._tiny import tiny_cells

CELLS = [w["name"] for w in harness.load_json(
    harness.REPO, "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control's TF32 exists only "
                    "there")
    return torch.device("cuda", 0)


def _entry(workload, seed, dev):
    harness.no_tf32()
    with tiny_cells():
        cell = harness.Cell.load(workload, seed, 0.0, False, dev)
    entry = importlib.import_module(
        f"port_bench.entries.{cell.workload['entry']}").Entry(cell)
    entry.free()
    harness.free_cuda()
    return cell, entry


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_program_and_control_on_the_card(workload, card):
    seed = 2 ** 31 + 29
    cell, entry = _entry(workload, seed, card)
    ok, rows = compare.verdict(entry.judge(), cell.limits)
    assert ok, rows
    ok, rows = compare.verdict(calibrate.control_numbers(entry, cell),
                               cell.limits)
    assert not ok, rows
