"""Multiple-Loss-Decomposition gradient surgery (reference utils/MLDOptim.py,
dormant upstream; ``Config.optimizer="mld"`` on the dual-branch trainers).

Port of ``ubpl_tpu/train/mld_optim.py:55-94``.  The reference calls two
accumulating backward passes over one graph (MLDOptim.py:18-56), so every
quantity its "primary" math touches is really the *total* gradient:

    ip      = <g_sec, g_tot>                                  (:36)
    cosine  = ip / (||g_tot|| * ||g_sec|| + eps)              (:46)
    vert    = g_sec - cosine * ||g_sec|| * g_tot / (||g_tot|| + eps)   (:53)
    g_final = g_tot - alpha * vert      if ip > 0             (:40,54)
    g_final = g_tot                     otherwise

``mld_combine`` reproduces these executed semantics (golden
``tests/goldens/mld.npz``).  Norms and the inner product are global: one L2
norm over every parameter the optimiser holds — in the dual-branch trainers
the parameters of BOTH students together, as the JAX package reduces over
its stacked branch axis.  The step (``mt_ubpl.optimize_and_ema``) runs one
forward and two ``torch.autograd.grad`` pullbacks, combines them here and
hands the result to AdamW.
"""
import torch


def _global_norm(tensors):
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def mld_combine(primary, secondary, alpha, eps=1e-12):
    """Combine two lists of gradients (one tensor per parameter) as the
    reference optimiser executes (see the module docstring).  Returns the
    list of combined gradients."""
    total = torch._foreach_add(primary, secondary)
    ip = torch.stack([x.sum() for x in torch._foreach_mul(secondary, total)]
                     ).sum()
    tot_norm = _global_norm(total)
    sec_norm = _global_norm(secondary)
    cosine = ip / (tot_norm * sec_norm + eps)
    vertical = torch._foreach_sub(
        secondary, torch._foreach_mul(total, cosine * sec_norm
                                      / (tot_norm + eps)))
    gate = (ip > 0).to(total[0].dtype) * alpha
    return torch._foreach_sub(total, torch._foreach_mul(vertical, gate))


def mld_gradients(primary_loss, secondary_loss, params):
    """The two loss groups' gradients over one forward: (g_pri, g_sec), one
    tensor per parameter; a parameter a loss does not reach gets zeros."""
    g_pri = torch.autograd.grad(primary_loss, params, retain_graph=True,
                                allow_unused=True, materialize_grads=True)
    g_sec = torch.autograd.grad(secondary_loss, params, allow_unused=True,
                                materialize_grads=True)
    return list(g_pri), list(g_sec)
