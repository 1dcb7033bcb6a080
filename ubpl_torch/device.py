"""Device and compute-dtype policy of the port.

Counterpart of the dtype handling spread over ``ubpl_tpu`` (``Config.
compute_dtype`` read in ``train/base_trainer.py:_make_model`` and
``infer.py``).  JAX placed arrays on its default backend; here every entry
point takes an explicit ``device``:

  * ``device=None`` means the CUDA device.  Without CUDA it raises: the
    port never drops to the CPU on its own.  Tests pass ``device="cpu"``.
  * ``compute_dtype="bfloat16"`` means bf16 autocast with fp32 parameters
    and ``channels_last`` activations on the card; on the CPU the port
    computes in fp32.
"""
import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: ubpl_torch runs on the GPU unless the "
                "caller passes device='cpu'")
        return torch.device("cuda")
    return torch.device(device)


def autocast(device: torch.device, compute_dtype: str):
    """bf16 autocast on CUDA for ``compute_dtype="bfloat16"``, else fp32."""
    if device.type == "cuda" and compute_dtype == "bfloat16":
        return torch.autocast("cuda", dtype=torch.bfloat16)
    return contextlib.nullcontext()


def memory_format(device: torch.device) -> torch.memory_format:
    """Activation layout: NHWC strides (``channels_last``) on the card,
    where cuDNN's convolutions prefer it; plain NCHW on the CPU."""
    if device.type == "cuda":
        return torch.channels_last
    return torch.contiguous_format
