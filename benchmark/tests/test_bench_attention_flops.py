"""The attention reader's cell and flops, and what a rounding tie in the
keypoint warp does to the heatmap check of the pose training cells."""
import pytest
import torch

from benchmark import attention_flops as AF
from benchmark import flops
from benchmark.harness import Cell
from benchmark.reference import augment as RA

CELL = "train-mt_ubpl-vitpose_h"


@pytest.mark.parametrize("argv", [
    ["benchmark/run.py", "--workload", CELL, "--seed", "1", "--seconds", "5"],
    ["/c/benchmark/run.py", f"--workload={CELL}", "--seed=1", "--seconds=5",
     "--trace=1"],
    ["run.py", "--work", CELL, "--seed", "1", "--sec", "5"]])
def test_current_cell_reads_the_command_line_as_run_py_does(argv):
    assert AF.current_cell(argv).name == CELL


@pytest.mark.parametrize("argv", [["pytest", "-q"], [], ["python3"]])
def test_current_cell_is_none_outside_run_py(argv):
    assert AF.current_cell(argv) is None


@pytest.mark.parametrize("br_num", [1, 2, 3])
def test_step_flops_follow_the_trainer_branches(br_num):
    """Each branch adds a teacher's forward and a student's forward and
    backward of every image and view: 4 forwards of the products."""
    cell = Cell(CELL)
    cell.config["hyper"]["br_num"] = br_num
    c, t = cell.config, cell.traffic
    per_image = AF.product_flops(c["model"], c["kps"], c["inp_res"])
    rows = t["batch_unlabeled"] + t["batch_labeled"]
    assert AF.branches(cell) == br_num
    assert AF.step_flops(cell) == rows * t["views"] * br_num * 4 * per_image
    # 4 N^2 width per image: N = 256 tokens, width 1280, 32 blocks
    assert per_image == 32 * 4 * 256 ** 2 * 1280
    assert per_image < flops.forward_flops(c["model"], c["kps"],
                                           c["inp_res"])


def _map(x, y):
    return RA.heatmaps(torch.tensor([[[float(x), float(y), 1.0]]]), 256,
                       64)[0]


@pytest.mark.parametrize("cell", ["train-mt_ubpl-hg3", CELL])
def test_a_rounding_tie_stays_under_the_heatmap_limit(cell):
    """The program and the reference compose the crop matrix in float32 in
    different orders, so a warped keypoint within a rounding of a whole
    pixel can truncate to the neighbouring one: that moves its map by at
    most 0.072 (both axes) of the peak, under the limit, while a whole map
    cell's shift reads over it."""
    limit = Cell(cell).limits["heatmap_gap"]
    tie = max(float((_map(x, y) - _map(x + dx, y + dy)).abs().max())
              for x in range(40, 44) for y in range(40, 44)
              for dx, dy in ((1, 0), (0, 1), (1, 1)))
    cell_shift = float((_map(40, 40) - _map(44, 40)).abs().max())
    assert 0.07 < tie < limit < cell_shift
