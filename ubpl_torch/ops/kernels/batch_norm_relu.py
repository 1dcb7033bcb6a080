"""Triton kernels: train-mode BatchNorm + ReLU with the conv bias folded in.

Replaces no Pallas kernel: it stands for XLA's fusion of
``ubpl_tpu/models/layers.py``'s ``nn.BatchNorm`` (train mode, flax's biased
running variance) with the ReLU after it.  ``y = relu(batch_norm_train(x +
conv_bias))`` and the running-statistics update in one forward pair of
passes, its gradient in one backward pair, for every train-mode BatchNorm of
the hourglass family that normalises this process's batch
(``models/layers.py``: ``Residual`` and ``ConvBlock(bn=True, relu=True)``).
The plain version, ``batch_norm_relu_plain``, is the composition the layers
ran before: the conv output plus its bias, ``BatchNorm``'s train path, then
``F.relu``.

Bound on the card: bytes.  Per element the work is a handful of fp32
operations, so the cost is moving the activations: the forward reads x
twice (statistics, then normalise) and writes y once; the backward reads x
and dy twice (the two per-channel sums, then dx) and writes dx once.  The
statistics are recomputed from x in the backward, and so is the ReLU's mask
(nothing beyond x, the per-channel mean and inverse std is saved).  The
conv bias is added in fp32 on the fly, so the conv runs without its bias
and no separate strided bias add or bias-gradient reduction touches the
activations: the bias gradient is summed from dx, in fp32, in the dx pass.

Design for that bound.  The input is the ``[N*H*W, C]`` matrix of a
``channels_last`` tensor; a program owns a block of rows and a block of
channels and reads 16-byte vectors along C.  Rows are split over a fixed
number of programs (``PROGRAMS``, about four per SM), each looping over its
rows with no reduction inside the loop: the statistics pass keeps Welford's
(mean, M2) in every slot of its tile, the backward passes plain sums, and
the slots are joined once at the end (a last partial tile joins as Chan et
al. join partial variances, stable in fp32 where a plain sum of squares is
not).  One small kernel combines the per-program partials in a fixed
order: here it writes the mean and inverse std and moves the running
statistics with flax's biased variance; the normalise pass then writes
``relu(x_hat * gamma + beta)``.  The backward mirrors it: partial sums of
``g = dy * mask`` and ``g * x_hat``, their sum by the same combine (the
gamma and beta gradients), and the dx pass with its per-program
bias-gradient partials, summed by it once more.  Five kernels in all, one
path for every shape: a forward is 3 launches, a backward 4 (3 without a
conv bias).  Every reduction is a
fixed-order combination of per-program partials, with no atomics, so the
same input gives the same bits; scratch comes from ``torch.empty`` and
nothing synchronises with the host, so the kernels run inside a CUDA graph.
Only block sizes, the dtypes and BatchNorm's momentum and eps are
compile-time constants; n, C and the combine's mode are runtime arguments,
so a cold cache compiles each kernel once per input dtype (the combine,
whose operands are fp32 for bf16 and fp32 input, once for both).  On an
H100 at HG3's shapes (bs 32) the pair takes about 44 ms of an MT_UBPL step
against a byte bound of 24 ms (PERF.md).

The wrapper launches the kernels for a CUDA tensor (bf16, fp32 or fp64;
statistics in fp32, or fp64 for fp64 input; one in another layout is
first copied to ``channels_last``) and raises on anything else; only a CPU
tensor goes to the plain version.  ``launches`` counts kernel launches
and ``calls`` the train-mode BatchNorm calls that took the kernels.  Both are Python counters: under a
CUDA graph they count at capture, not at replay.  Triton is imported, and
its cache directory (``.kernel_build/triton`` in the checkout) set, at the
first launch.
"""
import inspect
import os
from pathlib import Path

import torch
import torch.nn.functional as F

NAME = "batch_norm_relu"
SOURCE = "ubpl_torch/ops/kernels/batch_norm_relu.py"
REPLACES = ("none: XLA's fusion of ubpl_tpu/models/layers.py's nn.BatchNorm "
            "(train mode) and the ReLU after it")
BUILD_DIR = Path(__file__).resolve().parents[3] / ".kernel_build"

#: programs a pass over a large input aims at (about four per SM of an H100)
PROGRAMS = 512
BLOCK_R, BLOCK_C, WARPS = 64, 64, 4     # the passes over the activations
COMBINE_BLOCK_G, COMBINE_BLOCK_C = 256, 32   # the partials' combine

DTYPES = (torch.bfloat16, torch.float32, torch.float64)

launches = 0
calls = 0
_kernels = None


def _build():
    """Define (and on first use JIT-compile) the Triton kernels."""
    global _kernels
    if _kernels is not None:
        return _kernels
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    def kernel(fn):
        """``triton.jit`` that keeps the sizes and flags runtime values:
        one compiled kernel serves every shape."""
        names = inspect.signature(fn).parameters
        return triton.jit(fn, do_not_specialize=[
            a for a in ("n", "G", "rows_per_prog", "parts", "chan",
                        "has_bias", "update")
            if a in names])

    @triton.jit
    def _load(ptr, r0, end, cols, cmask, C, ACC: tl.constexpr,
              BLOCK_R: tl.constexpr):
        """A [BLOCK_R, BLOCK_C] tile of rows r0.. (< end) in ACC, its mask
        and offsets."""
        rows = r0 + tl.arange(0, BLOCK_R)
        m = (rows < end)[:, None] & cmask[None, :]
        offs = rows[:, None] * C + cols[None, :]
        return tl.load(ptr + offs, mask=m, other=0.0).to(ACC), m, offs

    @triton.jit
    def _chan(mean, m2, cnt, t_mean, t_m2, k):
        """Chan et al.: (mean, M2) of cnt values joined by a part of k."""
        tot = cnt + k
        delta = t_mean - mean
        return (mean + delta * (k / tot),
                m2 + t_m2 + delta * delta * (cnt * k / tot))

    @triton.jit
    def _tile_stats(v, m, k):
        """(mean, M2) per channel of a tile's k valid rows."""
        t_mean = tl.sum(tl.where(m, v, 0.0), axis=0) / k
        d = tl.where(m, v - t_mean[None, :], 0.0)
        return t_mean, tl.sum(d * d, axis=0)

    @triton.jit
    def _params(cb_ptr, w_ptr, beta_ptr, mean_ptr, invstd_ptr, cols, cmask,
                has_bias, ACC: tl.constexpr):
        """Per channel: conv bias (0 without one), gamma, beta, and the
        mean and inverse std the combine wrote."""
        b = tl.load(cb_ptr + cols, mask=cmask & (has_bias != 0),
                    other=0.0).to(ACC)
        return (b, tl.load(w_ptr + cols, mask=cmask, other=0.0).to(ACC),
                tl.load(beta_ptr + cols, mask=cmask, other=0.0).to(ACC),
                tl.load(mean_ptr + cols, mask=cmask, other=0.0),
                tl.load(invstd_ptr + cols, mask=cmask, other=0.0))

    @kernel
    def batch_norm_relu_stats_kernel(x_ptr, cb_ptr, part_ptr, n, C, G,
                                     rows_per_prog, has_bias,
                                     ACC: tl.constexpr,
                                     BLOCK_R: tl.constexpr,
                                     BLOCK_C: tl.constexpr):
        """(mean, M2) per channel of x + b over this program's rows:
        Welford's update in each slot of the tile over the whole tiles (no
        reduction inside the loop), the slots then joined, and a last
        partial tile joined as Chan et al. join partial variances."""
        g = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        b = tl.load(cb_ptr + cols, mask=cmask & (has_bias != 0),
                    other=0.0).to(ACC)
        start = g * rows_per_prog
        end = tl.minimum(start + rows_per_prog, n)
        mean = tl.zeros([BLOCK_R, BLOCK_C], ACC)
        m2 = tl.zeros([BLOCK_R, BLOCK_C], ACC)
        tiles = (end - start) // BLOCK_R
        for t in range(0, tiles):
            v, _, _ = _load(x_ptr, start + t * BLOCK_R, end, cols, cmask, C,
                            ACC, BLOCK_R)
            v = v + b[None, :]
            delta = v - mean
            mean += delta * (1.0 / (t + 1).to(ACC))
            m2 += delta * (v - mean)
        k = tiles.to(ACC)
        c_mean = tl.sum(mean, axis=0) / BLOCK_R
        d = mean - c_mean[None, :]
        c_m2 = tl.sum(m2 + k * d * d, axis=0)
        full = start + tiles * BLOCK_R
        for r0 in range(full, end, BLOCK_R):     # at most one, partial
            v, m, _ = _load(x_ptr, r0, end, cols, cmask, C, ACC, BLOCK_R)
            t_k = (end - r0).to(ACC)
            t_mean, t_m2 = _tile_stats(v + b[None, :], m, t_k)
            c_mean, c_m2 = _chan(c_mean, c_m2, k * BLOCK_R, t_mean, t_m2,
                                 t_k)
        tl.store(part_ptr + g * C + cols, c_mean, mask=cmask)
        tl.store(part_ptr + (G + g) * C + cols, c_m2, mask=cmask)

    @kernel
    def batch_norm_relu_combine_kernel(part_ptr, out_ptr, rm_ptr, rv_ptr, n,
                                       C, G, rows_per_prog, parts, chan,
                                       update, ACC: tl.constexpr,
                                       MOMENTUM: tl.constexpr,
                                       EPS: tl.constexpr,
                                       BLOCK_G: tl.constexpr,
                                       BLOCK_C: tl.constexpr):
        """Join the G per-program partials of each channel in a fixed
        order.  ``chan`` set: the statistics pass's (mean, M2), as Chan et
        al. join partial variances, into out = (mean, inverse std), and
        the running statistics moved with the biased variance where
        ``update`` is set.  Otherwise out[p] = the sum over g of part[p, g]
        for p < ``parts``."""
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        if chan != 0:
            mean = tl.zeros([BLOCK_C], ACC)
            m2 = tl.zeros([BLOCK_C], ACC)
            for g0 in range(0, G, BLOCK_G):
                gs = g0 + tl.arange(0, BLOCK_G)
                gmask = gs < G
                m = gmask[:, None] & cmask[None, :]
                cnt = tl.where(gmask, tl.minimum(n - gs * rows_per_prog,
                                                 rows_per_prog), 0).to(ACC)
                p_mean = tl.load(part_ptr + gs[:, None] * C + cols[None, :],
                                 mask=m, other=0.0)
                p_m2 = tl.load(part_ptr + (G + gs[:, None]) * C
                               + cols[None, :], mask=m, other=0.0)
                k = tl.sum(cnt, axis=0)
                t_mean = tl.sum(p_mean * cnt[:, None], axis=0) / k
                d = tl.where(m, p_mean - t_mean[None, :], 0.0)
                t_m2 = tl.sum(p_m2 + d * d * cnt[:, None], axis=0)
                mean, m2 = _chan(mean, m2, (g0 * rows_per_prog).to(ACC),
                                 t_mean, t_m2, k)
            var = m2 / n.to(ACC)
            tl.store(out_ptr + cols, mean, mask=cmask)
            tl.store(out_ptr + C + cols, 1.0 / tl.sqrt(var + EPS),
                     mask=cmask)
            um = cmask & (update != 0)
            rm = tl.load(rm_ptr + cols, mask=um, other=0.0)
            rv = tl.load(rv_ptr + cols, mask=um, other=0.0)
            tl.store(rm_ptr + cols, (rm.to(ACC) * (1.0 - MOMENTUM)
                                     + MOMENTUM * mean).to(rm.dtype), mask=um)
            tl.store(rv_ptr + cols, (rv.to(ACC) * (1.0 - MOMENTUM)
                                     + MOMENTUM * var).to(rv.dtype), mask=um)
        else:
            for p in range(0, parts):
                s = tl.zeros([BLOCK_C], ACC)
                for g0 in range(0, G, BLOCK_G):
                    gs = g0 + tl.arange(0, BLOCK_G)
                    m = (gs < G)[:, None] & cmask[None, :]
                    s += tl.sum(tl.load(part_ptr + (p * G + gs[:, None]) * C
                                        + cols[None, :], mask=m, other=0.0),
                                axis=0)
                tl.store(out_ptr + p * C + cols, s, mask=cmask)

    @kernel
    def batch_norm_relu_normalize_kernel(x_ptr, cb_ptr, w_ptr, beta_ptr,
                                         mean_ptr, invstd_ptr, y_ptr, n, C,
                                         rows_per_prog, has_bias,
                                         ACC: tl.constexpr,
                                         BLOCK_R: tl.constexpr,
                                         BLOCK_C: tl.constexpr):
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        b, w, beta, mean, invstd = _params(cb_ptr, w_ptr, beta_ptr, mean_ptr,
                                           invstd_ptr, cols, cmask, has_bias,
                                           ACC)
        start = tl.program_id(0) * rows_per_prog
        end = tl.minimum(start + rows_per_prog, n)
        for r0 in range(start, end, BLOCK_R):
            v, m, offs = _load(x_ptr, r0, end, cols, cmask, C, ACC, BLOCK_R)
            x_hat = (v + b[None, :] - mean[None, :]) * invstd[None, :]
            y = tl.maximum(x_hat * w[None, :] + beta[None, :], 0.0)
            tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=m)

    @kernel
    def batch_norm_relu_backward_reduce_kernel(x_ptr, dy_ptr, cb_ptr, w_ptr,
                                               beta_ptr, mean_ptr,
                                               invstd_ptr, part_ptr, n, C, G,
                                               rows_per_prog, has_bias,
                                               ACC: tl.constexpr,
                                               BLOCK_R: tl.constexpr,
                                               BLOCK_C: tl.constexpr):
        """Per channel, this program's sums of g = dy * relu'(y) and of
        g * x_hat."""
        g = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        b, w, beta, mean, invstd = _params(cb_ptr, w_ptr, beta_ptr, mean_ptr,
                                           invstd_ptr, cols, cmask, has_bias,
                                           ACC)
        start = g * rows_per_prog
        end = tl.minimum(start + rows_per_prog, n)
        sg = tl.zeros([BLOCK_R, BLOCK_C], ACC)
        sgx = tl.zeros([BLOCK_R, BLOCK_C], ACC)
        for r0 in range(start, end, BLOCK_R):
            v, m, offs = _load(x_ptr, r0, end, cols, cmask, C, ACC, BLOCK_R)
            dy = tl.load(dy_ptr + offs, mask=m, other=0.0).to(ACC)
            x_hat = (v + b[None, :] - mean[None, :]) * invstd[None, :]
            gr = tl.where(x_hat * w[None, :] + beta[None, :] > 0.0, dy, 0.0)
            sg += gr
            sgx += gr * x_hat
        tl.store(part_ptr + g * C + cols, tl.sum(sg, axis=0), mask=cmask)
        tl.store(part_ptr + (G + g) * C + cols, tl.sum(sgx, axis=0),
                 mask=cmask)

    @kernel
    def batch_norm_relu_backward_elemt_kernel(x_ptr, dy_ptr, cb_ptr, w_ptr,
                                              beta_ptr, mean_ptr, invstd_ptr,
                                              sums_ptr, dx_ptr, part_ptr, n,
                                              C, rows_per_prog, has_bias,
                                              ACC: tl.constexpr,
                                              BLOCK_R: tl.constexpr,
                                              BLOCK_C: tl.constexpr):
        """Write dx; store this program's per-channel sum of it (its part
        of the conv bias's gradient)."""
        g = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        b, w, beta, mean, invstd = _params(cb_ptr, w_ptr, beta_ptr, mean_ptr,
                                           invstd_ptr, cols, cmask, has_bias,
                                           ACC)
        inv_n = 1.0 / n.to(ACC)
        mg = tl.load(sums_ptr + cols, mask=cmask, other=0.0) * inv_n
        mgx = tl.load(sums_ptr + C + cols, mask=cmask, other=0.0) * inv_n
        k = w * invstd
        start = g * rows_per_prog
        end = tl.minimum(start + rows_per_prog, n)
        sdx = tl.zeros([BLOCK_R, BLOCK_C], ACC)
        for r0 in range(start, end, BLOCK_R):
            v, m, offs = _load(x_ptr, r0, end, cols, cmask, C, ACC, BLOCK_R)
            dy = tl.load(dy_ptr + offs, mask=m, other=0.0).to(ACC)
            x_hat = (v + b[None, :] - mean[None, :]) * invstd[None, :]
            gr = tl.where(x_hat * w[None, :] + beta[None, :] > 0.0, dy, 0.0)
            dx = (gr - mg[None, :] - x_hat * mgx[None, :]) * k[None, :]
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=m)
            sdx += tl.where(m, dx, 0.0)
        tl.store(part_ptr + g * C + cols, tl.sum(sdx, axis=0),
                 mask=cmask & (has_bias != 0))

    _kernels = {
        "tl": tl, "stats": batch_norm_relu_stats_kernel,
        "combine": batch_norm_relu_combine_kernel,
        "normalize": batch_norm_relu_normalize_kernel,
        "backward_reduce": batch_norm_relu_backward_reduce_kernel,
        "backward_elemt": batch_norm_relu_backward_elemt_kernel}
    return _kernels


def _cdiv(a, b):
    return -(-a // b)


def _split_rows(n, C):
    """(programs over the rows, rows per program) of a large pass: about
    ``PROGRAMS`` programs in all, each a whole number of row tiles."""
    G = max(1, min(_cdiv(n, BLOCK_R), _cdiv(PROGRAMS, _cdiv(C, BLOCK_C))))
    rows = _cdiv(_cdiv(n, G), BLOCK_R) * BLOCK_R
    return _cdiv(n, rows), rows


def _consts(x, bn):
    """The kernels' compile-time constants: statistics in fp32, or fp64 for
    an fp64 input; BatchNorm's momentum and eps (the backward's combines
    take the forward's, so both directions share one compiled combine)."""
    import triton.language as tl
    return dict(ACC=tl.float64 if x.dtype == torch.float64 else tl.float32,
                MOMENTUM=float(bn.momentum), EPS=float(bn.eps))


def _combine(K, part, out, rm, rv, n, C, G, rows, parts, chan, update,
             const):
    K["combine"][(_cdiv(C, COMBINE_BLOCK_C),)](
        part, out, rm, rv, n, C, G, rows, parts, chan, update, **const,
        BLOCK_G=COMBINE_BLOCK_G, BLOCK_C=COMBINE_BLOCK_C, num_warps=8)


def _forward(x, conv_bias, bn):
    """Launch the forward; returns (y, mean, invstd)."""
    global launches
    K = _build()
    const = _consts(x, bn)
    N, C, H, W = x.shape
    n = N * H * W
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = torch.empty_like(x)
    stats = torch.empty((2, C), dtype=acc, device=x.device)  # mean, invstd
    cb = bn.weight if conv_bias is None else conv_bias
    has_bias = int(conv_bias is not None)
    G, rows = _split_rows(n, C)
    part = torch.empty((2, G, C), dtype=acc, device=x.device)
    grid = (G, _cdiv(C, BLOCK_C))
    K["stats"][grid](x, cb, part, n, C, G, rows, has_bias, ACC=const["ACC"],
                     BLOCK_R=BLOCK_R, BLOCK_C=BLOCK_C, num_warps=WARPS)
    _combine(K, part, stats, bn.running_mean, bn.running_var, n, C, G, rows,
             2, 1, int(bn.update_stats), const)
    K["normalize"][grid](x, cb, bn.weight, bn.bias, stats[0], stats[1], y, n,
                         C, rows, has_bias, ACC=const["ACC"], BLOCK_R=BLOCK_R,
                         BLOCK_C=BLOCK_C, num_warps=WARPS)
    launches += 3
    return y, stats[0], stats[1]


def _backward(dy, x, conv_bias, weight, bias, mean, invstd, const):
    """Launch the backward; returns (dx, d conv_bias or None, d weight,
    d bias)."""
    global launches
    K = _build()
    N, C, H, W = x.shape
    n = N * H * W
    acc = mean.dtype
    dy = dy.contiguous(memory_format=torch.channels_last)
    dx = torch.empty_like(x)
    sums = torch.empty((2, C), dtype=acc, device=x.device)   # g, g * x_hat
    has_bias = int(conv_bias is not None)
    cb = weight if conv_bias is None else conv_bias
    G, rows = _split_rows(n, C)
    part = torch.empty((2, G, C), dtype=acc, device=x.device)
    grid = (G, _cdiv(C, BLOCK_C))
    K["backward_reduce"][grid](
        x, dy, cb, weight, bias, mean, invstd, part, n, C, G, rows,
        has_bias, ACC=const["ACC"], BLOCK_R=BLOCK_R, BLOCK_C=BLOCK_C,
        num_warps=WARPS)
    # the sum mode takes no running statistics: ``sums`` stands in for them
    _combine(K, part, sums, sums, sums, n, C, G, rows, 2, 0, 0, const)
    K["backward_elemt"][grid](
        x, dy, cb, weight, bias, mean, invstd, sums, dx, part, n, C, rows,
        has_bias, ACC=const["ACC"], BLOCK_R=BLOCK_R, BLOCK_C=BLOCK_C,
        num_warps=WARPS)
    launches += 3
    d_cb = None
    if has_bias:
        dcb = torch.empty(C, dtype=acc, device=x.device)
        _combine(K, part, dcb, dcb, dcb, n, C, G, rows, 1, 0, 0, const)
        launches += 1
        d_cb = dcb.to(conv_bias.dtype)
    return (dx, d_cb, sums[1].to(weight.dtype), sums[0].to(bias.dtype))


class _BatchNormReLU(torch.autograd.Function):
    """The kernels' forward and backward; ``bn`` holds the running
    statistics, momentum, eps and ``update_stats``."""

    @staticmethod
    def forward(ctx, x, conv_bias, weight, bias, bn):
        y, mean, invstd = _forward(x, conv_bias, bn)
        ctx.const = _consts(x, bn)
        ctx.save_for_backward(x, conv_bias, weight, bias, mean, invstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, conv_bias, weight, bias, mean, invstd = ctx.saved_tensors
        dx, d_cb, d_w, d_b = _backward(dy, x, conv_bias, weight, bias, mean,
                                       invstd, ctx.const)
        return dx, d_cb, d_w, d_b, None


def batch_norm_relu_plain(x, conv_bias, bn):
    """``relu(bn(x + conv_bias))`` as the layers composed it: the conv
    output plus its bias (in the output's dtype), ``BatchNorm``'s train
    path (flax's biased running-variance update unless ``bn.update_stats``
    is off), then ``F.relu``."""
    if conv_bias is not None:
        x = x + conv_bias.to(x.dtype).view(1, -1, 1, 1)
    return F.relu(bn(x))


def _check(x, conv_bias, bn):
    if x.dim() != 4 or x.dtype not in DTYPES:
        raise ValueError(f"x must be a 4-d {', '.join(map(str, DTYPES))} "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"x has {x.numel()} elements; the kernels index "
                         "with 32 bits")
    C = x.shape[1]
    tensors = [bn.weight, bn.bias, bn.running_mean, bn.running_var]
    if conv_bias is not None:
        tensors.append(conv_bias)
    for t in tensors:
        if t.device != x.device or t.shape != (C,) or not t.is_contiguous():
            raise ValueError(f"BatchNorm parameters, running statistics and "
                             f"the conv bias must be contiguous [{C}] "
                             f"tensors on {x.device}")


def batch_norm_relu(x, conv_bias, bn):
    """``relu(batch_norm_train(x + conv_bias))`` for ``x`` ``[N, C, H, W]``
    and a ``models.layers.BatchNorm`` ``bn`` in train mode (its running
    statistics move unless ``bn.update_stats`` is off); ``conv_bias`` is
    the ``[C]`` bias of the conv that made ``x``, or None.

    CUDA tensor: the kernels, on ``x`` in channels_last memory (copied
    there if it is not).  CPU tensor: the plain version.  Any other device
    raises.
    """
    global calls
    if x.device.type == "cpu":
        return batch_norm_relu_plain(x, conv_bias, bn)
    if x.device.type != "cuda":
        raise ValueError(f"no BatchNorm + ReLU kernel for device {x.device}")
    _check(x, conv_bias, bn)
    calls += 1
    # the kernels read channels_last rows; the training path's activations
    # are already laid out so (a float64 network's convs are not: copied)
    x = x.contiguous(memory_format=torch.channels_last)
    return _BatchNormReLU.apply(x, conv_bias, bn.weight, bn.bias, bn)
