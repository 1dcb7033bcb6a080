"""The analytic counts of ``benchmark/flops.py`` against what the
program executes: ``FlopCounterMode`` over the program's networks and one
real training step at a small size, and the heatmap kernel's tensors."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark.tests.conftest import tiny_cell


def counted(fn):
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


@pytest.mark.parametrize("arch,k,res", [("HG1", 5, 64), ("HG2", 9, 64),
                                        ("ResNet18", 10, 32)])
def test_forward_flops_equal_the_counter(arch, k, res):
    from ubpl_torch.models import create_class_model, create_pose_model
    torch.manual_seed(0)
    net = (create_pose_model(arch, k, "AvgPool") if arch.startswith("HG")
           else create_class_model("ResNet", k, "AvgPool")).eval()
    x = torch.randn(2, 3, res, res)
    with torch.no_grad():
        got = counted(lambda: net(x))
    assert got == 2 * flops.forward_flops(arch, k, res)


@pytest.mark.parametrize("name", ["train-mt_ubpl-hg3",
                                  "train-mt_ubpl-resnet18"])
def test_step_flops_equal_the_counter(name):
    cell = tiny_cell(name)
    prog = cell.runner().Program(cell, 5, torch.device("cpu"))
    batch = next(prog.batches)
    assert counted(lambda: prog._step(batch)) == prog.flops_per_step


def test_mesh_step_flops_equal_the_one_card_step_at_the_same_batch():
    one = tiny_cell("train-mt_ubpl-hg3")
    mesh = tiny_cell("train-mt_ubpl-hg3-model2-data2")
    bs = ("batch_unlabeled", "batch_labeled", "views")
    assert [one.traffic[k] for k in bs] == [mesh.traffic[k] for k in bs]
    cpu = torch.device("cpu")
    ranks = mesh.runner().Program(mesh, 5, cpu)
    win = ranks.window(0.0)
    ranks.release()
    assert win.units >= 1
    assert win.flops / win.units == \
        one.runner().Program(one, 5, cpu).flops_per_step


def test_mt_ubpl_step_counts_sixteen_forwards_per_image_and_view_pair():
    fwd = flops.forward_flops("HG3", 9, 256)
    step = flops.teacher_student_step_flops("HG3", 9, 256, 32, 2, 2, 2)
    first = flops.layers("HG3", 9, 256)[0][1]
    # 2 views x (2 students x 3 passes + 2 teachers), less the first
    # layer's input gradient of each student pass
    assert step == 32 * 2 * (8 * fwd - 2 * first)
    assert fwd == 22964338688


def test_heatmap_bytes_equal_the_launch_tensors():
    from ubpl_torch.ops.heatmap import synthesize_heatmaps
    B, K, out = 32, 9, 64
    kps = torch.rand(B, K, 3) * 200
    hm, kps_new = synthesize_heatmaps(kps, 256, out)
    moved = sum(t.numel() * t.element_size() for t in (kps, hm, kps_new))
    assert flops.heatmap_bytes(B, K, out) == moved
