"""The reference networks by name.

A module of this package that provides networks declares them in a list
``NETWORKS`` of ``Network`` entries; ``lookup`` finds them on first use,
so a new network comes in with a new module and edits none.  A test may
``register`` a network of its own.  A name that two entries match (the
same prefix twice, or "HG" and "HG3") is refused, so that a new module
can never change the network that an existing name builds.  An entry
says

  * which names it builds: ``prefix`` ("HG" builds "HG1", "HG3"), or the
    whole name where ``exact``;
  * ``build(arch, classes_or_kps)``, the network;
  * ``drawn(model)``: [(state name, shape, fan_in)] of the tensors drawn
    at random (uniform on +-1/sqrt(fan_in)); by default every weight and
    bias of a convolution, transposed convolution and linear layer, with
    fan_in = one output's weight elements (``nets.drawn_layers``, PyTorch's
    default initialisation);
  * ``products``: module class -> ``flops(module, inputs, output)`` of one
    image, for work that no weighted layer does, such as attention's two
    products of activations;
  * ``off_loss_path``: layers whose output the training loss does not read
    (no backward).
"""
import importlib
import pkgutil
from dataclasses import dataclass, field
from typing import Callable, Optional

_TABLE = []
_FOUND = False


@dataclass(frozen=True)
class Network:
    prefix: str
    build: Callable
    exact: bool = False
    drawn: Optional[Callable] = None
    products: dict = field(default_factory=dict)
    off_loss_path: tuple = ()

    def matches(self, arch):
        return arch == self.prefix if self.exact else \
            arch.startswith(self.prefix)


def register(network):
    """Adds ``network``; raises where an entry declares its name or
    prefix already."""
    for other in _TABLE:
        if (other.prefix, other.exact) == (network.prefix, network.exact):
            kind = "name" if network.exact else "prefix"
            raise ValueError(f"two reference networks declare the {kind} "
                             f"{network.prefix!r}")
    _TABLE.append(network)


def unregister(network):
    _TABLE.remove(network)


def _find():
    """Every ``NETWORKS`` entry of this package's modules, once."""
    global _FOUND
    if _FOUND:
        return
    package = importlib.import_module(__package__)
    for info in pkgutil.iter_modules(package.__path__):
        mod = importlib.import_module(f"{__package__}.{info.name}")
        for network in getattr(mod, "NETWORKS", ()):
            register(network)
    _FOUND = True


def lookup(arch):
    """The one entry that builds ``arch``; raises where none or several
    match it."""
    _find()
    hits = [n for n in _TABLE if n.matches(arch)]
    if len(hits) != 1:
        raise ValueError(f"{len(hits)} reference networks build {arch!r} "
                         f"(have {sorted(n.prefix for n in _TABLE)})")
    return hits[0]
