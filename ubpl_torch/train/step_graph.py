"""The training step after its views, replayed as one CUDA graph.

A Mean Teacher step (``mt_ubpl.teacher_student_step``) issues some 27,000
device operations at HG3, each a Python or autograd call on the host; the
card waits on the host for most of the step.  ``StepGraph`` captures
everything the step does after its views — the teachers' and students'
forwards, the losses and metrics, ``zero_grad`` and the backward, AdamW's
step and the EMA — in one ``torch.cuda.CUDAGraph`` and replays it.  The
views stay eager: the trainer's generator draws as before and the heatmap
kernel is called from Python.  Port-only: ``ubpl_tpu`` has no counterpart,
since XLA compiles the JAX package's jitted step (``ubpl_tpu/train/
mt_ubpl.py``) into one program that the host launches once.

Per input shape (the views' fields and ``islabeled``): the first step runs
eagerly on a side stream (it creates AdamW's state and cuDNN's choices, as
a warm-up before a capture must), the second captures the graph and
replays it, later steps copy their inputs into the graph's buffers and
replay.  The schedule (the step's loss weights and the EMA rate) is a
device tensor of the students' dtype that the step reads
(``with_schedule``), uploaded through pinned memory when it changes, so an
epoch's new values need no new capture.  Each replay's metrics are cloned
out of the graph's buffers: every step returns its own values.
``torch.cuda.graph`` releases the allocator's cached blocks before it
captures, so the warm-up's freed activations do not sit beside the graph's
private pool (ViTPose-H's step would need most of the card twice over).

Whether the graph engages (``engages``: a CUDA card, one process, AdamW,
no ``remat``) is decided once, when the trainer is built; off
(``enabled=False``) a call is the eager step with the schedule's floats.
A graph keeps the config's other values that the step reads, as it keeps
AdamW's rate.  ``graph_captures``, ``graph_replays`` (the capturing step
included) and ``eager_steps`` count the calls.
"""
import torch

from ..utils.profiling import span


def engages(device, group, branches, cfg):
    """Whether a step after the views can replay as one graph: on a CUDA
    card, in one process (a batch or branch group puts collectives inside
    the step), with AdamW (MLD takes two pullbacks and combines them) and
    without recomputed forwards (``remat``)."""
    return (device.type == "cuda" and group is None and branches is None
            and cfg.optimizer == "adamw" and not cfg.remat)


def schedule_values(weights, ema_alpha):
    """The weights, the EMA rate and 1 - the rate, worked out on the host
    as the eager step's float arithmetic does."""
    return (*weights, ema_alpha, 1.0 - ema_alpha)


def with_schedule(body, views, islabeled, schedule):
    """``body(views, islabeled, *weights, ema_alpha=(rate, 1 - rate))``
    with every value a 0-dim tensor of ``schedule`` (``schedule_values``
    in one tensor): the step as the graph runs it."""
    *weights, alpha, rest = schedule.unbind(0)
    return body(views, islabeled, *weights, ema_alpha=(alpha, rest))


def _buffers(view):
    """Buffers like one view's tensor fields (None fields stay None)."""
    return type(view)(*(None if t is None else torch.empty_like(t)
                        for t in view))


class _Shape:
    """The graph of one input shape: its input buffers and outputs."""

    def __init__(self, views, islabeled):
        self.views = [_buffers(v) for v in views]
        self.islabeled = torch.empty_like(islabeled)
        self.graph = self.out = None

    def load(self, views, islabeled):
        for static, view in zip(self.views, views):
            for s, t in zip(static, view):
                if s is not None:
                    s.copy_(t)
        self.islabeled.copy_(islabeled)

    def run(self, body, schedule):
        return with_schedule(body, self.views, self.islabeled, schedule)


class StepGraph:
    """A trainer's step after the views, with a graph per input shape and
    the counters; ``enabled``: whether ``engages`` held at set-up."""

    def __init__(self, device, enabled):
        self.device, self.enabled = device, enabled
        self.graph_captures = self.graph_replays = self.eager_steps = 0
        self._shapes = {}
        self._schedule = self._values = None    # device tensor, its values
        self._side = None

    def reset(self):
        """Drop every graph: the parameters, buffers or optimiser state it
        holds were replaced.  The next step at each shape runs eagerly and
        captures again."""
        self._shapes.clear()

    def _device_schedule(self, weights, ema_alpha, dtype):
        """The schedule as one device tensor of ``dtype``, rewritten in
        place when its values change (the graphs read it); a new dtype
        drops the graphs that read the old tensor."""
        values = schedule_values(weights, ema_alpha)
        if self._schedule is None or self._schedule.dtype != dtype:
            self.reset()
            self._schedule = torch.empty(len(values), dtype=dtype,
                                         device=self.device)
            self._values = None
        if self._values != values:
            self._schedule.copy_(torch.tensor(values, dtype=dtype)
                                 .pin_memory(), non_blocking=True)
            self._values = values
        return self._schedule

    def __call__(self, body, views, islabeled, weights, ema_alpha, dtype):
        """One step: ``body(views, islabeled, *weights, ema_alpha=...)``
        returns its metrics (a dict of tensors).  Replayed, ``weights`` are
        0-dim device tensors of ``dtype`` (the students' parameters') and
        ``ema_alpha`` the device pair (rate, 1 - rate); eager, the floats
        themselves."""
        if not self.enabled:
            self.eager_steps += 1
            return body(views, islabeled, *weights, ema_alpha=ema_alpha)
        schedule = self._device_schedule(weights, ema_alpha, dtype)
        key = tuple((t.shape, t.dtype) for v in (*views, [islabeled])
                    for t in v if t is not None)
        shape = self._shapes.get(key)
        if shape is None:
            shape = self._shapes[key] = _Shape(views, islabeled)
            shape.load(views, islabeled)
            self.eager_steps += 1
            return self._warm_up(shape, body, schedule)
        shape.load(views, islabeled)
        if shape.graph is None:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                shape.out = shape.run(body, schedule)
            shape.graph = graph
            self.graph_captures += 1
        with span("train.replay"):
            shape.graph.replay()
        self.graph_replays += 1
        return {k: v.clone() for k, v in shape.out.items()}

    def _warm_up(self, shape, body, schedule):
        """The eager step on a side stream, as a capture's warm-up."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            out = shape.run(body, schedule)
        main.wait_stream(self._side)
        return out
