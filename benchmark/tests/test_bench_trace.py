"""The reduction of profiler events to the per-layer metrics, on events
made by hand: busy time as the union of device intervals, idle gaps
labelled by the innermost host operator, and each reader's arithmetic."""
import pytest
import torch

from benchmark import harness, trace


class Event:
    def __init__(self, name, start, dur, device=False, thread=1,
                 kind=None):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._t = device, thread
        self._k = kind or ("kernel" if device else "cpu_op")

    def name(self):
        return self._n

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._dev
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._k.endswith("user_annotation")

    def start_thread_id(self):
        return self._t

    def activity_type(self):
        return self._k


EVENTS = [
    Event("aten::conv2d", 0, 1000), Event("aten::convolution", 10, 900),
    Event("aten::batch_norm", 1000, 1000),
    Event("cudaLaunchKernel", 20, 5, kind="cuda_runtime"),
    Event("sm90_xmma_fprop_implicit_gemm", 100, 200, device=True),
    Event("sm90_xmma_fprop_implicit_gemm", 250, 150, device=True),
    Event("batch_norm_collect_statistics", 1300, 100, device=True),
    Event("Memcpy HtoD (Pinned -> Device)", 1800, 100, device=True,
          kind="gpu_memcpy"),
    Event("Optimizer.step#AdamW.step", 0, 2000, device=True,
          kind="gpu_user_annotation"),
]


def test_summary_busy_union_and_gaps():
    s = trace.summarize(EVENTS, units=2, wall=4e-6)
    # [100, 400) + [1300, 1400) + [1800, 1900): the annotation is no work
    assert s.busy_s == pytest.approx(500e-9)
    assert s.launches() == 4
    assert s.ops["sm90_xmma_fprop_implicit_gemm"] == [pytest.approx(
        350e-9), 2]
    # gaps [400, 1300) in conv2d/convolution (mid 850: convolution is
    # innermost) and [1400, 1800) in batch_norm
    assert s.gaps == {"aten::convolution": pytest.approx(900e-9),
                      "aten::batch_norm": pytest.approx(400e-9)}
    b = s.breakdown()
    assert b["device_ops"][0][0] == "sm90_xmma_fprop_implicit_gemm"
    assert len(b["idle_gaps"]) == 2


def measured(summary, chips=1, window_s=1.0, units=2):
    win = harness.Window(units=units, seconds=window_s, flops=1e13)
    return harness.Measured(win, summary, 989.4e12, 3.35e12, chips,
                            {"heatmap_synth": 4 * 32 * 9 * (6 + 64 * 64)})


def test_readers():
    s = trace.summarize(EVENTS, units=2, wall=4e-6)
    m = measured(s)
    read = {n: harness.reader(n)(m) for n in (
        "train.launches_per_step", "train.host_us_per_launch",
        "train.conv_ms_per_step", "train.batchnorm_ms_per_step",
        "train.idle_share", "train.mfu", "serve.h2d_ms_per_request",
        "serve.mfu", "serve.idle_share", "heatmap_synth_roofline")}
    assert read["train.launches_per_step"] == 2
    assert read["train.host_us_per_launch"] == pytest.approx(0.5 / 2 * 1e6)
    assert read["train.conv_ms_per_step"] == pytest.approx(350e-9 / 2 * 1e3)
    assert read["train.batchnorm_ms_per_step"] == pytest.approx(
        100e-9 / 2 * 1e3)
    assert read["train.idle_share"] == pytest.approx(
        100 * (1 - 250e-9 / 0.5))
    assert read["train.mfu"] == pytest.approx(100 * 1e13 / 989.4e12)
    assert read["serve.h2d_ms_per_request"] == pytest.approx(
        100e-9 / 2 * 1e3)
    # no heatmap launch in the stretch: the roofline is not reported
    assert read["heatmap_synth_roofline"] is None


def test_roofline_of_a_launch():
    ev = [Event("heatmap_synth_kernel", 0, 2800, device=True)]
    m = measured(trace.summarize(ev, units=1, wall=1e-5))
    bound = 4 * 32 * 9 * (6 + 64 * 64) / 3.35e12
    assert harness.reader("heatmap_synth_roofline")(m) == pytest.approx(
        100 * bound / 2.8e-6)


def test_mfu_over_chips_and_unknown_card():
    s = trace.summarize(EVENTS, units=2, wall=4e-6)
    assert harness.reader("train.mfu")(measured(s, chips=4)) == \
        pytest.approx(100 * 1e13 / (4 * 989.4e12))
    m = measured(s)
    m.peak_flops = None
    assert harness.reader("train.mfu")(m) is None


def test_peaks_table():
    assert harness.peaks("NVIDIA H100 80GB HBM3", "bfloat16") == (
        989.4e12, 3.35e12)
    assert harness.peaks("some other card", "bfloat16") == (None, None)


def test_collective_readers():
    ev = EVENTS + [
        Event("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 2000, 300,
              device=True),
        Event("ncclDevKernel_AllGather_RING_LL", 2400, 100, device=True)]
    m = measured(trace.summarize(ev, units=2, wall=4e-6))
    assert harness.reader("parallel.collectives_per_step")(m) == 1
    assert harness.reader("parallel.collective_ms_per_step")(m) == \
        pytest.approx(400e-9 / 2 * 1e3)
    # one card: no NCCL kernel, nothing reported
    m = measured(trace.summarize(EVENTS, units=2, wall=4e-6))
    assert harness.reader("parallel.collectives_per_step")(m) is None
    assert harness.reader("parallel.collective_ms_per_step")(m) is None
