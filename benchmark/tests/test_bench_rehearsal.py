"""A CPU rehearsal of every cell at a tiny size: the harness drives the
program through set-up, window and check, the reference follows one
training step or the served requests, and the line carries no card
metric.  On the CPU the program computes in float32, so it agrees with
the reference far inside the card's limits."""
import pytest
import torch

from benchmark import harness
from benchmark.runners.training import readings_gaps
from benchmark.tests.conftest import cells, tiny, tiny_cell

CELLS = cells()
CPU = torch.device("cpu")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cpu_run_is_correct_and_prints_no_card_metric(name, trace):
    cell = tiny_cell(name)
    correct, line, checks = harness.run(cell, 2 ** 31 + 7, 0.05, trace,
                                        CPU, 0.0)
    assert correct and line["correct"]
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    assert "busy_s" not in line["device"]
    if trace:
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert {n for n, *_ in checks} == set(cell.limits)


@pytest.mark.parametrize("name", ["train-mt_ubpl-hg3",
                                  "train-mt_ubpl-resnet18"])
def test_one_training_step_matches_the_reference(name):
    cell = tiny_cell(name)
    cell.traffic["check_steps"] = 1
    kept = cell.runner().Program(cell, 11, CPU).release()
    gaps = readings_gaps(kept.readings, kept.reference())
    assert gaps["loss_gap"][0] < 1e-5
    assert gaps["grad_gap_median"][0] < 1e-4
    assert gaps["grad_gap"][0] < 1e-2
    terms = [k for k in gaps if k.endswith("_gap") and k[:-4] in
             kept.readings.terms]
    assert len(terms) == 4
    assert all(gaps[k][0] < 1e-5 for k in terms), gaps
    if "count_gap" in gaps:
        assert gaps["count_gap"][0] == 0
    if "heatmap_gap" in gaps:
        assert gaps["heatmap_gap"][0] < 1e-6


def test_served_requests_match_the_reference():
    cell = tiny_cell("serve-clips-hg3")
    prog = cell.runner().Program(cell, 11, CPU)
    prog.window(0.0)             # one request
    kept = prog.release()
    assert len(kept.served) == 1
    position, score = kept.reference_gaps()
    assert position == 0.0 and score < 1e-4


def test_same_seed_same_inputs():
    cell = tiny_cell("train-mt_ubpl-hg3")
    a = cell.runner().Program(cell, 2 ** 31 + 3, CPU)
    b = cell.runner().Program(cell, 2 ** 31 + 3, CPU)
    assert all(torch.equal(a.states[0][k], b.states[0][k])
               for k in a.states[0])
    assert a.readings.losses == b.readings.losses
    assert [list(x) for x in a.check_batches] == [list(x) for x in
                                                  b.check_batches]


@pytest.mark.parametrize("part", ["config", "traffic"])
def test_a_cell_without_a_tiny_cut_fails_at_once(part):
    cell = harness.Cell("train-mt_ubpl-hg3")
    del getattr(cell, part)["tiny"]
    what = "configuration" if part == "config" else "traffic"
    with pytest.raises(ValueError, match=f'its {what} has no "tiny"'):
        tiny(cell)
