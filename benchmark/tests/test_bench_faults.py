"""The harness, with its look for a card skipped, run over a program
broken underneath: each fault that a cell can have turns ``correct``
false.  The cell that spans cards runs its gloo ranks on the CPU, each
with the fault planted."""
import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests.conftest import tiny_cell

CPU = torch.device("cpu")
TRAIN = ["train-mt_ubpl-hg3", "train-mt_ubpl-resnet18"]
MESH = "train-mt_ubpl-hg3-model2-data2"


def run(cell, fault=None):
    with calibrate.plant(cell, fault):
        correct, line, checks = harness.run(cell, 2 ** 31 + 9, 0.05, 0,
                                            CPU, 0.0)
    return correct, {n: (v, lim) for n, v, lim, _ in checks}


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged(name, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k:
                        None)
    correct, checks = run(tiny_cell(name))
    assert not correct
    assert checks["change_gap_median"][0] == 1.0
    assert checks["change_gap"][0] == 1.0


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out(name):
    correct, checks = run(tiny_cell(name), "half_batch")
    assert not correct


@pytest.mark.parametrize("fault, number", [
    ("heatmap_zero", "heatmap_gap"), ("heatmap_shift", "heatmap_gap"),
    ("fdc_left_out", "fdc_gap")])
def test_pose_step_fault(fault, number):
    correct, checks = run(tiny_cell("train-mt_ubpl-hg3"), fault)
    assert not correct
    assert checks[number][0] > checks[number][1]
    if fault == "fdc_left_out":
        assert checks[number][0] == 1.0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "exchange_left_out"])
def test_fault_on_every_rank(fault):
    correct, checks = run(tiny_cell(MESH), fault)
    assert not correct
    if fault == "state_unchanged":
        assert checks["change_gap"][0] == 1.0


def test_answer_altered_where_it_is_produced():
    correct, checks = run(tiny_cell("serve-clips-hg3"), "moved_answer")
    assert not correct
    assert checks["argmax_gap"][0] > checks["argmax_gap"][1]
