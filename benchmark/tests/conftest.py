"""Shared set-up of the benchmark's own tests: the checkout's root on the
path, one torch thread, and tiny copies of the cells for the CPU."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_cell(name):
    """The cell ``name`` with its files read, cut to a size the CPU runs
    in seconds: HG1 at 64 -> 16 px with 5 joints, batches of 2 + 2 (pose)
    or 6 + 2 (classification), one serving chunk of 4 frames."""
    from benchmark import harness
    cell = harness.Cell(name)
    c, t = cell.config, cell.traffic
    if c["model"].startswith("HG"):
        c.update(model="HG1", kps=5, inp_res=64, out_res=16)
    if t["runner"] == "train_pose":
        t.update(batch_unlabeled=2, batch_labeled=2, dataset_images=32)
    elif t["runner"] == "train_class":
        t.update(batch_unlabeled=6, batch_labeled=2, train_images=64,
                 valid_images=8, labeled_images=16)
    elif t["runner"] == "serve_clips":
        t.update(batch_size=4, min_frames=1, max_frames=8, length_step=1,
                 frame_pool=16,
                 warmup_lengths=[8, 1], check_frames=16)
    return cell


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
