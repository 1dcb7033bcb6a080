"""Triton kernel: fused Gaussian heatmap synthesis with the visibility gate.

Replaces the Pallas TPU kernel ``_synth_kernel`` / ``synthesize_heatmaps_
pallas`` (``ubpl_tpu/ops/pallas/heatmap_kernel.py:26-74``, the
``pl.pallas_call`` at ``:59``) together with its XLA wrapper: one launch
reads kps ``[B, K, 3]``, writes the targets ``[B, K, H, W]`` in the port's
NCHW layout (no transpose) and writes ``kps_new`` with the re-gated
visibility.  Same values as ``ops.heatmap.synthesize_heatmaps``, its plain
version.

Bound on the card: bytes.  Each output element is one ``exp`` of data
computed from two scalars, so there is no reuse to exploit and nothing to
stage in shared memory; the work is the store of ``B*K*H*W*4`` bytes
(4.7 MB at B=32, K=9, 64x64: about 1.4 us at 3.35 TB/s) plus the launch.
Design for that bound: a grid over (sample*joint, row tile), each program
writing a [BLOCK_H, W] tile with the column index on the fast axis, so
consecutive threads store consecutive addresses (16-byte vector stores);
at the main-path shape that is 1,152 programs of 4 KB each, enough to
spread over all 132 SMs.  The program of row tile 0 also writes the
joint's ``kps_new`` entry.

The wrapper launches the kernel for CUDA tensors and raises on what it does
not take; only a CPU tensor goes to the plain version.  ``launches`` counts
kernel launches.  Triton is imported, and its cache directory
(``.kernel_build/triton`` in the checkout) set, at the first launch.
"""
import os
from pathlib import Path

import torch

from ..heatmap import synthesize_heatmaps as synthesize_heatmaps_plain

NAME = "heatmap_synth"
SOURCE = "ubpl_torch/ops/kernels/heatmap_synth.py"
REPLACES = "ubpl_tpu/ops/pallas/heatmap_kernel.py:59"
BUILD_DIR = Path(__file__).resolve().parents[3] / ".kernel_build"

launches = 0
_kernel = None


def _build():
    """Define (and on first use JIT-compile) the Triton kernel."""
    global _kernel
    if _kernel is not None:
        return _kernel
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def heatmap_synth_kernel(kps_ptr, hm_ptr, kps_new_ptr, inp_res, stride,
                             sig, inv_2s2, OUT: tl.constexpr,
                             BLOCK_H: tl.constexpr, BLOCK_W: tl.constexpr):
        j = tl.program_id(0)                    # flat (sample, joint)
        t = tl.program_id(1)                    # row tile
        x = tl.load(kps_ptr + j * 3)
        y = tl.load(kps_ptr + j * 3 + 1)
        xi = libdevice.trunc(x)
        yi = libdevice.trunc(y)
        cx = tl.math.div_rn(xi, stride)
        cy = tl.math.div_rn(yi, stride)
        rows = t * BLOCK_H + tl.arange(0, BLOCK_H)
        cols = tl.arange(0, BLOCK_W)
        dy = rows.to(tl.float32) - cy
        dx = cols.to(tl.float32) - cx
        d2 = (dx * dx)[None, :] + (dy * dy)[:, None]
        k = tl.exp(-d2 * inv_2s2)
        k = tl.where(k < 0.01, 0.0, tl.minimum(k, 1.0))
        mask = (rows[:, None] < OUT) & (cols[None, :] < OUT)
        offs = j * OUT * OUT + rows[:, None] * OUT + cols[None, :]
        tl.store(hm_ptr + offs, k, mask=mask)
        if t == 0:
            v = tl.load(kps_ptr + j * 3 + 2)
            ok = ((xi + sig + 1 < inp_res) & (yi + sig + 1 < inp_res)
                  & (xi - sig >= 0) & (yi - sig >= 0))
            tl.store(kps_new_ptr + j * 3, x)
            tl.store(kps_new_ptr + j * 3 + 1, y)
            tl.store(kps_new_ptr + j * 3 + 2, v * ok.to(tl.float32))

    _kernel = heatmap_synth_kernel
    return _kernel


def synthesize_heatmaps(kps, inp_res=256, out_res=64, kernel_size=3.0,
                        sigma=1.0):
    """Heatmap targets + re-gated keypoints; same contract as
    ``ops.heatmap.synthesize_heatmaps`` for kps ``[B, K, 3]`` float32.

    CUDA tensor: one kernel launch (contiguous input required).
    CPU tensor: the plain version.  Any other device raises.
    """
    global launches
    if kps.dim() != 3 or kps.shape[-1] != 3 or kps.dtype != torch.float32:
        raise ValueError(f"kps must be float32 [B, K, 3], got "
                         f"{kps.dtype} {tuple(kps.shape)}")
    if kps.device.type == "cpu":
        return synthesize_heatmaps_plain(kps, inp_res, out_res, kernel_size,
                                         sigma)
    if kps.device.type != "cuda":
        raise ValueError(f"no heatmap kernel for device {kps.device}")
    if not kps.is_contiguous():
        raise ValueError("kps must be contiguous")
    B, K, _ = kps.shape
    heatmaps = torch.empty((B, K, out_res, out_res), dtype=torch.float32,
                           device=kps.device)
    kps_new = torch.empty_like(kps)
    if B * K == 0:
        return heatmaps, kps_new
    block_w = 1 << (out_res - 1).bit_length()        # next power of two
    block_h = max(1, min(block_w, 1024 // block_w))
    sig = float(sigma * kernel_size)
    _build()[(B * K, -(-out_res // block_h))](
        kps, heatmaps, kps_new, float(inp_res), float(inp_res / out_res),
        sig, 1.0 / (2.0 * sig * sig), OUT=out_res, BLOCK_H=block_h,
        BLOCK_W=block_w, num_warps=4)
    launches += 1
    return heatmaps, kps_new
