"""Inference / serving API.

Port of ``ubpl_tpu/infer.py:30-147``: ``PoseEstimator`` turns BGR uint8
images ``[N, R, R, 3]`` into keypoints ``[N, K, 2]`` (image coordinates)
and scores ``[N, K]``: normalise -> hourglass forward (eval BN) -> argmax
decode of the last stack.

Requests are cut into fixed-size chunks (the last one zero-padded, its
padding masked off on return).  On the card each chunk is staged in pinned
host memory and copied with ``non_blocking``; its results come back by a
non-blocking copy read only after the next chunk has been queued, so host
staging overlaps device compute.

    est = PoseEstimator.from_torch_checkpoint("checkpoint.pth.tar",
                                              model="HG3", kps_count=9)
    kps, scores = est.predict(images_u8)

``from_checkpoint`` (the JAX package's own checkpoint format) is not
ported yet.
"""
import numpy as np
import torch

from .config import Config
from .device import memory_format, resolve_device
from .models import create_pose_model
from .models.weights import load_reference_checkpoint, load_state
from .train.common import predict_keypoints


class PoseEstimator:
    def __init__(self, model, state_dict, means, cfg: Config,
                 batch_size: int = 32, device=None):
        """model: a port pose model; state_dict: its weights (reference key
        names, e.g. from ``models.weights``); means: BGR channel means."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch_size = batch_size
        load_state(model, state_dict)
        self.model = model.to(self.device,
                              memory_format=memory_format(self.device)).eval()
        self.means = torch.as_tensor(means, dtype=torch.float32,
                                     device=self.device)
        self._staging = [None, None]

    @classmethod
    def from_torch_checkpoint(cls, path, model="HG3", kps_count=9,
                              feature_mode="AvgPool", means=(0., 0., 0.),
                              head="ema", branch: int = 1,
                              batch_size: int = 32, device=None, **cfg_kw):
        """Serve a reference checkpoint (ckpts/checkpoint[_best].pth.tar of
        any reference regime).  branch: 1 or 2 for the dual-network regimes;
        head="ema" uses the EMA teacher."""
        sd, _ = load_reference_checkpoint(path, branch=branch, head=head)
        cfg = Config(model=model, feature_mode=feature_mode, **cfg_kw)
        cfg.kps_count = kps_count
        net = create_pose_model(model, kps_count, feature_mode)
        return cls(net, sd, means, cfg, batch_size, device)

    def _host_buffer(self, slot):
        """Reusable staging buffer for one chunk (pinned on the card)."""
        if self._staging[slot] is None:
            R = self.cfg.inp_res
            self._staging[slot] = torch.empty(
                (self.batch_size, R, R, 3), dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
        return self._staging[slot]

    def predict(self, images_u8):
        """images_u8: numpy [N, inp_res, inp_res, 3] BGR uint8.
        Returns (kps [N, K, 2] image coords, scores [N, K]) as numpy."""
        images_u8 = np.asarray(images_u8)
        R, K = self.cfg.inp_res, self.cfg.kps_count
        if images_u8.dtype != np.uint8 or images_u8.shape[1:] != (R, R, 3):
            raise ValueError(f"expected uint8 [N, {R}, {R}, 3], got "
                             f"{images_u8.dtype} {images_u8.shape}")
        N, bs = images_u8.shape[0], self.batch_size
        kps = np.zeros((N, K, 2), np.float32)
        scores = np.zeros((N, K), np.float32)
        pending = None
        for i, start in enumerate(range(0, N, bs)):
            n = min(bs, N - start)
            host = self._host_buffer(i % 2)
            host[:n].copy_(torch.from_numpy(images_u8[start:start + n]))
            host[n:].zero_()
            with torch.inference_mode():
                coords, sc = predict_keypoints(
                    self.model, host.to(self.device, non_blocking=True),
                    self.means, self.cfg)
                out = (coords.to("cpu", non_blocking=True),
                       sc.to("cpu", non_blocking=True))
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            if pending is not None:
                self._collect(pending, kps, scores)
            pending = (start, n, out, done)
        if pending is not None:
            self._collect(pending, kps, scores)
        return kps, scores

    @staticmethod
    def _collect(pending, kps, scores):
        start, n, (coords, sc), done = pending
        if done is not None:
            done.synchronize()
        kps[start:start + n] = coords[:n].numpy()
        scores[start:start + n] = sc[:n].numpy()
