"""Network weights made on the device from a seed, in one draw.

The tensors that the network's ``registry`` entry draws (by default every
convolution and linear weight and bias) are uniform on +-1/sqrt(fan_in)
(PyTorch's default initialisation); every other tensor of the state
starts at 1 where its name ends in "weight" or "running_var", else at 0
(BatchNorm's and LayerNorm's starts).  Names and shapes come from the
reference network (``reference.nets``), whose keys are the program's, so
one state dict loads into both.
"""
import torch

from .reference import nets, registry


def make_states(arch, classes_or_kps, copies, seed, device):
    """``copies`` state dicts of the reference network ``arch``, fp32 on
    ``device``, from one ``torch.rand`` call of a generator seeded with
    ``seed``."""
    with torch.device("meta"):
        model = nets.build(arch, classes_or_kps)
    drawn = (registry.lookup(arch).drawn or nets.drawn_layers)(model)
    sizes = [s.numel() for _, s, _ in drawn]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    u = torch.rand(copies, sum(sizes), generator=g, device=device)
    u = u.mul_(2.0).sub_(1.0)
    states = []
    for c in range(copies):
        sd = {}
        for (name, shape, fan_in), x in zip(drawn, u[c].split(sizes)):
            sd[name] = (x * fan_in ** -0.5).view(shape)
        for name, t in model.state_dict().items():
            if name in sd:
                continue
            fill = 1.0 if name.endswith(("weight", "running_var")) else 0.0
            sd[name] = torch.full(t.shape, fill, device=device)
        states.append(sd)
    return states
