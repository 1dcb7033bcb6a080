"""Weight carrier: JAX-package parameters and reference checkpoints into the
port's ``StackedHourglass``.

Port of the mapping in ``ubpl_tpu/models/torch_import.py:26-111``
(``hourglass_entries``, kept here as the port's own copy) and of its
``load_reference_checkpoint``.  The port's ``state_dict`` keys *are* the
reference keys (``pre.*``, ``hgs.{i}.0.*``, ``features.{i}.*``,
``preds.{i}``, ``merge_{preds,features}.{i}.conv``), so:

  * ``state_dict_from_jax`` turns the JAX package's nested flax dicts
    (numpy arrays under flax auto-names) into a port ``state_dict``,
    conv kernels HWIO -> OIHW;
  * ``load_reference_checkpoint`` reads a reference ``.pth.tar`` and drops
    what the port does not have: the never-run same-width ``skip_layer``
    convs and ``num_batches_tracked``.
"""
import numpy as np
import torch


def _conv(entries, t, f, bn):
    """Reference Conv module at torch prefix `t` <-> flax ConvBlock at `f`."""
    entries.append(("p", f + ("Conv_0", "kernel"), t + ".conv.weight", True))
    entries.append(("p", f + ("Conv_0", "bias"), t + ".conv.bias", False))
    if bn:
        entries.append(("p", f + ("BatchNorm_0", "scale"),
                        t + ".bn.weight", False))
        entries.append(("p", f + ("BatchNorm_0", "bias"),
                        t + ".bn.bias", False))
        entries.append(("s", f + ("BatchNorm_0", "mean"),
                        t + ".bn.running_mean", False))
        entries.append(("s", f + ("BatchNorm_0", "var"),
                        t + ".bn.running_var", False))


def _residual(entries, t, f, skip):
    """Reference Residual <-> flax ResidualBlock; `skip` is the reference's
    need_skip (inp_dim != out_dim)."""
    for i, bn in enumerate(("bn1", "bn2", "bn3")):
        entries.append(("p", f + (f"BatchNorm_{i}", "scale"),
                        f"{t}.{bn}.weight", False))
        entries.append(("p", f + (f"BatchNorm_{i}", "bias"),
                        f"{t}.{bn}.bias", False))
        entries.append(("s", f + (f"BatchNorm_{i}", "mean"),
                        f"{t}.{bn}.running_mean", False))
        entries.append(("s", f + (f"BatchNorm_{i}", "var"),
                        f"{t}.{bn}.running_var", False))
    off = 0
    if skip:
        _conv(entries, f"{t}.skip_layer", f + ("ConvBlock_0",), False)
        off = 1
    for j, c in enumerate(("conv1", "conv2", "conv3")):
        _conv(entries, f"{t}.{c}", f + (f"ConvBlock_{j + off}",), False)


def _hourglass(entries, t, f, n):
    """Reference recursive Hourglass <-> flax HourglassBlock."""
    _residual(entries, f"{t}.up1", f + ("ResidualBlock_0",), False)
    _residual(entries, f"{t}.low1", f + ("ResidualBlock_1",), False)
    if n > 1:
        _hourglass(entries, f"{t}.low2", f + ("HourglassBlock_0",), n - 1)
        _residual(entries, f"{t}.low3", f + ("ResidualBlock_2",), False)
    else:
        _residual(entries, f"{t}.low2", f + ("ResidualBlock_2",), False)
        _residual(entries, f"{t}.low3", f + ("ResidualBlock_3",), False)


def hourglass_entries(n_stack, mode="AvgPool"):
    """(kind, flax_path, torch_key, is_conv_kernel) for the whole
    StackedHourglass; kind "p" -> params, "s" -> batch_stats.

    For mode="ConvOne" the projection conv maps to the port-only key
    ``project.{i}``; reference checkpoints have no counterpart."""
    e = []
    _conv(e, "pre.0", ("ConvBlock_0",), True)
    _residual(e, "pre.1", ("ResidualBlock_0",), True)
    _residual(e, "pre.3", ("ResidualBlock_1",), False)
    _residual(e, "pre.4", ("ResidualBlock_2",), True)
    convs_per_stack = 3 if mode == "ConvOne" else 2
    for i in range(n_stack):
        _hourglass(e, f"hgs.{i}.0", (f"HourglassBlock_{i}",), 4)
        _residual(e, f"features.{i}.0", (f"ResidualBlock_{3 + i}",), False)
        base = 1 + convs_per_stack * i
        _conv(e, f"features.{i}.1", (f"ConvBlock_{base}",), True)
        if mode == "ConvOne":
            _conv(e, f"project.{i}", (f"ConvBlock_{base + 1}",), False)
        _conv(e, f"preds.{i}",
              (f"ConvBlock_{base + convs_per_stack - 1}",), False)
        if i < n_stack - 1:
            _conv(e, f"merge_preds.{i}.conv",
                  (f"Merge_{2 * i}", "ConvBlock_0"), False)
            _conv(e, f"merge_features.{i}.conv",
                  (f"Merge_{2 * i + 1}", "ConvBlock_0"), False)
    return e


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def state_dict_from_jax(params, batch_stats, n_stack, mode="AvgPool"):
    """JAX-package (params, batch_stats) nested dicts -> port state_dict
    (float32 CPU tensors, reference key names, OIHW conv kernels)."""
    sd = {}
    for kind, fpath, tkey, is_kernel in hourglass_entries(n_stack, mode):
        w = np.array(_get(params if kind == "p" else batch_stats, fpath),
                     np.float32)
        if is_kernel and w.ndim == 4:
            w = np.transpose(w, (3, 2, 0, 1))   # HWIO -> OIHW
        sd[tkey] = torch.from_numpy(np.ascontiguousarray(w))
    return sd


def checkpoint_state_key(keys, branch=1, head="ema"):
    """Which reference layout holds the network: model{branch}[_ema]_state
    (MT_UBPL/DualPose), model[_ema]_state (MT), model_state (supervised).
    head="ema" prefers the EMA teacher, which every reference regime
    validates and selects on."""
    candidates = ([f"model{branch}_ema_state", "model_ema_state"]
                  if head == "ema" else [])
    candidates += [f"model{branch}_state", "model_state"]
    key = next((k for k in candidates if k in keys), None)
    if key is None:
        raise KeyError(f"no model state among checkpoint keys {list(keys)}")
    return key


def load_reference_checkpoint(path, branch=1, head="ema"):
    """Read one network from a reference ``checkpoint[_best].pth.tar``.

    Returns (state_dict for the port's StackedHourglass, meta).  The dead
    same-width ``skip_layer`` convs and ``num_batches_tracked`` counters
    are dropped; a live skip conv (width change) is kept.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    key = checkpoint_state_key(ckpt.keys(), branch, head)
    raw = ckpt[key]
    sd = {}
    for k, v in raw.items():
        if k.endswith("num_batches_tracked"):
            continue
        if ".skip_layer." in k:
            prefix = k[:k.index(".skip_layer.")]
            w = raw[prefix + ".skip_layer.conv.weight"]
            if w.shape[0] == w.shape[1]:     # same width: never executed
                continue
        sd[k] = v.detach().float()
    meta = {"source_key": key,
            "current_epoch": int(ckpt.get("current_epoch", -1)),
            "best_acc": ckpt.get("best_acc")}
    return sd, meta


def load_state(model, state_dict):
    """``model.load_state_dict`` that tolerates only the port-only ConvOne
    projection (``project.*``) being absent, as it is from reference
    checkpoints; any other missing or unexpected key raises."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.startswith("project.")]
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return model
