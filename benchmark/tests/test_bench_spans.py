"""The reduction of the program's spans (``benchmark/spans.py``) on events
made by hand: spans on a stepping thread, launches from it and from a
second thread linked to their kernels by correlation ids, idle gaps put
down to phases or to ``between_steps``; the readings' arithmetic; and a
CPU rehearsal of a training and the serving cell at a tiny size."""
import numpy as np
import pytest
import torch

from benchmark import harness, spans
from benchmark.runners.serve_clips import clip_lengths
from benchmark.tests.conftest import tiny_cell

CPU = torch.device("cpu")
STEP, AUTOGRAD = 1, 2


class Event:
    def __init__(self, name, start, dur, kind="cpu_op", thread=STEP,
                 corr=0):
        self._n, self._s, self._d, self._k = name, start, dur, kind
        self._t, self._c = thread, corr

    def name(self):
        return self._n

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._k in (
            "kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
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

    def correlation_id(self):
        return self._c


def span(name, start, end, thread=STEP):
    return Event(name, start, end - start, "user_annotation", thread)


def launch(corr, at, kernel_start, kernel_dur, thread=STEP):
    return [Event("cudaLaunchKernel", at, 5, "cuda_runtime", thread, corr),
            Event(f"kernel_{corr}", kernel_start, kernel_dur, "kernel",
                  corr=corr)]


def step_events(t0):
    """One step from ``t0``: views [0, 100), forward [100, 300), losses
    [300, 400), backward [400, 700) (its kernels launched from autograd's
    thread), update [700, 800); one kernel launched in each phase."""
    return [
        span("train.step", t0, t0 + 800),
        span("train.views", t0, t0 + 100),
        span("train.forward", t0 + 100, t0 + 300),
        span("train.losses", t0 + 300, t0 + 400),
        span("train.backward", t0 + 400, t0 + 700),
        span("train.update", t0 + 700, t0 + 800),
        Event("aten::conv2d", t0 + 110, 50),
        *launch(t0 + 1, t0 + 10, t0 + 20, 30),              # views
        *launch(t0 + 2, t0 + 120, t0 + 150, 100),           # forward
        *launch(t0 + 3, t0 + 310, t0 + 320, 10),            # losses
        *launch(t0 + 4, t0 + 420, t0 + 500, 150, AUTOGRAD),  # backward
        *launch(t0 + 5, t0 + 710, t0 + 720, 40),            # update
        # the profiler's own annotations are not the program's
        Event("Optimizer.step#AdamW.step", t0 + 700, 90, "user_annotation"),
        Event("Optimizer.step#AdamW.step", t0 + 720, 40,
              "gpu_user_annotation"),
    ]


def test_two_steps_reduced_per_phase():
    ev = step_events(0) + step_events(1000)
    out = spans.reduce(ev)
    assert set(out) == {"train.step", "between_steps",
                        *(f"train.{p}" for p in spans.PHASES)}
    step = out["train.step"]
    assert step["count"] == 2
    assert step["host_s"] == pytest.approx(1600e-9)
    assert step["self_s"] == pytest.approx(0.0)         # phases cover it
    assert step["launches"] == 0 and step["idle_s"] == 0
    fwd, bwd = out["train.forward"], out["train.backward"]
    assert fwd["count"] == 2 and fwd["host_s"] == pytest.approx(400e-9)
    assert fwd["device_s"] == pytest.approx(200e-9) and fwd["launches"] == 2
    # launched from the second thread while the stepping one is inside
    # backward: backward's
    assert bwd["device_s"] == pytest.approx(300e-9) and bwd["launches"] == 2
    # device busy [20, 50) [150, 250) [320, 330) [500, 650) [720, 760)
    # per step; gaps at midpoints 100 (forward), 285 (forward), 415
    # (backward), 685 (backward), and [760, 1020) across the steps
    assert out["train.views"]["idle_s"] == pytest.approx(0)
    assert fwd["idle_s"] == pytest.approx(2 * (100 + 70) * 1e-9)
    assert bwd["idle_s"] == pytest.approx(2 * (170 + 70) * 1e-9)
    assert out["train.losses"]["idle_s"] == pytest.approx(0)
    assert out["between_steps"]["idle_s"] == pytest.approx(260e-9)
    total = sum(v["idle_s"] for v in out.values())
    assert total == pytest.approx((2 * 410 + 260) * 1e-9)


def test_self_time_and_nesting_on_one_thread_only():
    ev = [span("serve.request", 0, 1000),
          span("serve.stage", 0, 200), span("serve.forward", 200, 600),
          # a span on another thread is not the stepping thread's
          span("serve.forward", 100, 900, thread=AUTOGRAD),
          *launch(1, 50, 300, 100),
          *launch(2, 250, 400, 100)]
    out = spans.reduce(ev)
    assert out["serve.request"]["self_s"] == pytest.approx(400e-9)
    assert out["serve.forward"]["count"] == 1
    assert out["serve.stage"]["device_s"] == pytest.approx(100e-9)
    assert out["serve.forward"]["device_s"] == pytest.approx(100e-9)
    # kernels [300, 400) and [400, 500) leave no gap
    assert sum(v["idle_s"] for v in out.values()) == 0


def test_unrecorded_launch_and_no_program_span():
    # a host operator's own id never matches a kernel's; a kernel whose
    # launch call is missing counts where it ran
    ev = [span("serve.request", 0, 100), span("serve.stage", 0, 50),
          Event("aten::add", 60, 5, corr=9), Event("k", 10, 5, "kernel",
                                                   corr=9)]
    assert spans.reduce(ev)["serve.stage"]["launches"] == 1
    # the parent commit's program opens no span: nothing to read
    ev = [Event("aten::mm", 0, 100), *launch(1, 10, 20, 30)]
    assert spans.reduce(ev) == {}
    assert spans.training_idle_ms({}, 1.0, 0.5) is None
    assert spans.serving_readings({}, {}) == {
        "serve.padded_share": None, "serve.stage_ms_per_chunk": None,
        "serve.normalize_ms_per_chunk": None}


def test_six_idle_readings_add_up_to_the_idle_share():
    """Scaled by the unprofiled idle per step, the six add up to
    ``train.idle_share`` / 100 x the window's ms per step."""
    from benchmark.trace import summarize
    ev = step_events(0) + step_events(1000)
    summary = summarize(ev, units=2, wall=2e-6)
    window = harness.Window(units=4, seconds=8e-6, flops=0.0)
    m = harness.Measured(window, summary, None, None, 1, {})
    idle_share = harness.reader("train.idle_share")(m)
    out = spans.training_idle_ms(spans.reduce(ev), 2e-6,
                                 summary.busy_s / 2)
    assert len(out) == 6 and out["train.views_idle_ms"] == 0
    assert sum(out.values()) == pytest.approx(idle_share / 100 * 2e-3)
    assert out["train.between_steps_idle_ms"] == pytest.approx(
        260 / 1080 * (2e-6 - 330e-9) * 1e3)


def test_padded_share_of_one_cycle_of_the_cell():
    """Clips of 8-256 frames in steps of 8 in chunks of 128: 4,224 frames
    asked for, 6,144 computed, 31.25% padding."""
    t = harness.Cell("serve-clips-hg3").traffic
    gen = clip_lengths(t, 2 ** 31 + 5)
    n_lengths = len(range(t["min_frames"], t["max_frames"] + 1,
                          t["length_step"]))
    lengths = [next(gen) for _ in range(n_lengths)]
    bs = t["batch_size"]
    counters = {"frames_requested": sum(lengths),
                "frames_computed": sum(-(-n // bs) * bs for n in lengths)}
    assert counters == {"frames_requested": 4224, "frames_computed": 6144}
    assert spans.padded_share(counters) == 31.25
    stage = {"count": 4, "host_s": 0.02, "device_s": 0.0}
    norm = {"count": 4, "host_s": 0.001, "device_s": 0.056}
    r = spans.serving_readings({"serve.stage": stage,
                                "serve.normalize": norm}, counters)
    assert r["serve.stage_ms_per_chunk"] == pytest.approx(5.0)
    assert r["serve.normalize_ms_per_chunk"] == pytest.approx(14.0)


@pytest.mark.parametrize("name", ["train-mt_ubpl-resnet18",
                                  "serve-clips-hg3"])
def test_cpu_rehearsal_of_a_cell(name):
    """The command's measurement at a tiny size on the CPU: the program's
    spans are found (no device work, so no device time) and the serving
    counters move over the window."""
    line = spans.measure(tiny_cell(name), 2 ** 31 + 7, 0.05, CPU)
    assert line["device"] == "cpu" and line["per_layer"] == {}
    if name.startswith("serve"):
        assert {"serve.request", "serve.stage", "serve.normalize",
                "serve.forward", "serve.collect"} <= set(line["spans"])
        c = line["window"]["counters"]
        assert 0 < c["frames_requested"] <= c["frames_computed"]
        assert line["readings"]["serve.padded_share"] == pytest.approx(
            100 * (1 - c["frames_requested"] / c["frames_computed"]))
        assert line["spans"]["serve.stage"]["count"] == 1
    else:
        assert {"train.step", *(f"train.{p}" for p in spans.PHASES)} <= set(
            line["spans"])
        assert line["spans"]["train.step"]["count"] == 1
        assert np.isfinite(list(line["readings"].values())).all()
