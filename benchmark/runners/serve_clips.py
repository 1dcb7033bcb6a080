"""Runner of the clip-serving cells: the program's ``PoseEstimator.predict``
driven in a closed loop by one client, one clip of uint8 BGR host frames
per request.

Traffic parameters: ``batch_size`` (the estimator's chunk), clip lengths
from ``min_frames`` to ``max_frames`` in steps of ``length_step`` (each
length once per cycle of requests, the order shuffled from the seed, so
every seed sends the same mix), ``frame_pool`` distinct host frames from which a clip is a run of
consecutive frames at an offset drawn from the seed, ``warmup_lengths``
(the requests of the set-up), ``trace_requests`` (the profiled stretch)
and ``check_frames`` (the least number of served frames the check
compares, in whole requests drawn from the seed, the longest one among
them).

End-to-end: served frames of all completed requests over the window, and
the 95th percentile of all requests' latencies (call to return, the host
copy of the answer included).
"""
import time

import numpy as np
import torch

from .. import compare, flops
from .. import weights as W
from ..harness import Window, seeds
from ..reference import nets
from ..reference import pose as RP


def clip_lengths(traffic, seed):
    """Endless clip lengths: every length of the range once per cycle."""
    rng = np.random.default_rng(seed)
    lengths = np.arange(traffic["min_frames"], traffic["max_frames"] + 1,
                        traffic["length_step"])
    while True:
        yield from rng.permutation(lengths).tolist()


class Program:
    def __init__(self, cell, seed, device):
        from ubpl_torch.config import Config
        from ubpl_torch.infer import PoseEstimator
        from ubpl_torch.models import create_pose_model
        c, t = cell.config, cell.traffic
        self.cell, self.device = cell, device
        s_frames, s_weights, s_order, s_offsets, s_check = seeds(seed, 5)
        R = c["inp_res"]
        g = torch.Generator(device=device)
        g.manual_seed(s_frames)
        self.frames = torch.randint(0, 256, (t["frame_pool"], R, R, 3),
                                    generator=g, device=device,
                                    dtype=torch.uint8).cpu().numpy()
        self.state = W.make_states(c["model"], c["kps"], 1, s_weights,
                                   device)[0]
        cfg = Config(model=c["model"], feature_mode=c["feature_mode"],
                     compute_dtype=c["compute_dtype"], inp_res=R,
                     out_res=c["out_res"])
        cfg.kps_count = c["kps"]
        net = create_pose_model(c["model"], c["kps"], c["feature_mode"])
        self.est = PoseEstimator(net, self.state, tuple(c["means"]), cfg,
                                 batch_size=t["batch_size"], device=device)
        self.lengths = clip_lengths(t, s_order)
        self.offsets = np.random.default_rng(s_offsets)
        self.check_seed = s_check
        self.fwd_flops = flops.forward_flops(c["model"], c["kps"], R)
        for n in t["warmup_lengths"]:
            self.est.predict(self.frames[:n])
        self.stretch_units = t["trace_requests"]

    def _request(self):
        n = next(self.lengths)
        off = int(self.offsets.integers(0, len(self.frames) - n + 1))
        t0 = time.perf_counter()
        kps, scores = self.est.predict(self.frames[off:off + n])
        return off, n, kps, scores, time.perf_counter() - t0

    def window(self, seconds):
        self.served, lat = [], []
        t0 = time.perf_counter()
        while True:
            off, n, kps, scores, dt = self._request()
            self.served.append((off, n, kps, scores))
            lat.append(dt)
            if time.perf_counter() - t0 >= seconds:
                break
        dt = time.perf_counter() - t0
        frames = sum(n for _, n, _, _ in self.served)
        return Window(len(lat), dt, frames * self.fwd_flops,
                      {"serve_images_per_s": frames / dt,
                       "serve_p95_ms": float(np.percentile(lat, 95)) * 1e3})

    def stretch(self):
        for _ in range(self.stretch_units):
            self._request()

    def release(self):
        kept = Kept(self.cell, self.device, self.state, self.frames,
                    self.served, self.check_seed)
        del self.est
        return kept


def check_sample(served, min_frames, seed):
    """Indices of served requests to compare: the longest, then others in
    an order drawn from ``seed`` until ``min_frames`` frames are covered."""
    order = np.random.default_rng(seed).permutation(len(served)).tolist()
    longest = max(range(len(served)), key=lambda i: served[i][1])
    pick, frames = [longest], served[longest][1]
    for i in order:
        if frames >= min_frames:
            break
        if i != longest:
            pick.append(i)
            frames += served[i][1]
    return pick


class Kept:
    kernel_bytes = {}

    def __init__(self, cell, device, state, frames, served, seed):
        self.cell, self.device, self.state = cell, device, state
        self.frames, self.served, self.seed = frames, served, seed

    def check(self):
        return numbers(self.reference_gaps(), self.cell.limits)

    def reference_gaps(self, precision="fp32", answers=None):
        """(position gap, score gap), worst over the sampled requests, of
        ``answers`` (by default the program's) against the reference."""
        c = self.cell.config
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            net = nets.build(c["model"], c["kps"]).to(self.device)
            net.load_state_dict(self.state)
            nets.set_precision(net, "fp32")
            means = torch.tensor(c["means"], device=self.device)
            pos = score = 0.0
            pick = check_sample(self.served,
                                self.cell.traffic["check_frames"], self.seed)
            for i in pick:
                off, n, kps, scores = self.served[i]
                frames = torch.as_tensor(self.frames[off:off + n],
                                         device=self.device)
                maps = RP.serve_maps(net, frames, means)
                if answers is not None:
                    kps, scores = answers(net, frames, means, precision)
                p, s = compare.decode_gaps(
                    torch.as_tensor(kps, device=self.device),
                    torch.as_tensor(scores, device=self.device), maps,
                    c["inp_res"])
                pos, score = max(pos, p), max(score, s)
            return pos, score
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32[0]
            torch.backends.cudnn.allow_tf32 = tf32[1]


def numbers(gaps, limits):
    pos, score = gaps
    return [("argmax_gap", pos, limits["argmax_gap"],
             "reference map's maximum less its value at the served "
             "position, in map standard deviations"),
            ("score_gap", score, limits["score_gap"],
             "served score less the reference map's maximum, in map "
             "standard deviations")]


def reference_answers(net, frames, means, precision):
    """The reference's own decode in ``precision``: the control's answers
    (argmax position in image pixels, maximum)."""
    nets.set_precision(net, precision)
    try:
        maps = RP.serve_maps(net, frames, means)
    finally:
        nets.set_precision(net, "fp32")
    N, K, H, W = maps.shape
    flat = maps.flatten(-2)
    top, idx = flat.max(-1)
    x = (idx % W + 1).float()
    y = (idx // W + 1).float()
    ok = (top > 0).float()
    stride = frames.shape[1] // W
    coords = torch.stack([stride * (x * ok - 1) + 1,
                          stride * (y * ok - 1) + 1], -1)
    return coords, top
