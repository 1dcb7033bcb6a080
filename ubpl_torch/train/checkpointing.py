"""Checkpoint save/restore in the reference ``.pth.tar`` layout.

Counterpart of ``ubpl_tpu/train/checkpointing.py`` (which writes orbax
trees).  The port writes what the reference trainers write
(utils/base/comm.py:91-103) and what ``models/weights.py`` already reads:
one ``torch.save`` dict per checkpoint,

    ckpts/checkpoint.pth.tar         every epoch
    ckpts/checkpoint_best.pth.tar    when the epoch is the best so far

holding ``current_epoch``, the regime's networks under the reference keys
(``model_state``; ``model_state`` + ``model_ema_state``;
``model{1,2}_state`` + ``model{1,2}_ema_state``) in the reference's own
layout (``models/weights.py:export_reference_state``, so the reference's
strict ``load_state_dict`` takes them), ``optim_state`` and the
metadata (``best_acc``, ``best_epoch``; after a pseudo-label round also
``pseudo_rounds_done``, ``pseudo_kps``, ``pseudo_islabeled`` and
``pseudo_lma`` as tensors).  Each file is written under a
temporary name and moved into place with ``os.replace``, so a crash during
the write leaves the previous checkpoint intact.
"""
import os

import torch

_CKPT_DIR = "ckpts"


def checkpoint_paths(base_path):
    """(latest, best) file names under ``base_path``."""
    d = os.path.join(os.path.abspath(base_path), _CKPT_DIR)
    return (os.path.join(d, "checkpoint.pth.tar"),
            os.path.join(d, "checkpoint_best.pth.tar"))


def save_checkpoint(base_path, epoch, trainer_state, is_best=False,
                    extra=None):
    """Write ``trainer_state`` (a dict of ``*_state`` entries: network
    ``state_dict``s and the optimiser's) as the latest checkpoint, and as
    the best one too when ``is_best``."""
    latest, best = checkpoint_paths(base_path)
    os.makedirs(os.path.dirname(latest), exist_ok=True)
    payload = {"current_epoch": int(epoch), **trainer_state,
               **(extra or {})}
    for target, write in ((latest, True), (best, is_best)):
        if not write:
            continue
        staged = f"{target}.new"
        torch.save(payload, staged)
        os.replace(staged, target)


def restore_checkpoint(base_path, best=False):
    """Read a checkpoint back onto the CPU.  Returns (state, meta): the
    ``*_state`` entries, and the rest (``current_epoch``, ``best_acc``,
    ``best_epoch``); (None, None) when there is no checkpoint."""
    latest, best_p = checkpoint_paths(base_path)
    target = best_p if best else latest
    if not os.path.exists(target):
        return None, None
    ckpt = torch.load(target, map_location="cpu", weights_only=True)
    state = {k: v for k, v in ckpt.items() if k.endswith("_state")}
    meta = {k: v for k, v in ckpt.items() if k not in state}
    return state, meta
