"""Device mesh of the port: which process holds which rows of the batch.

Counterpart of ``ubpl_tpu/parallel/mesh.py``.  The JAX package builds a
``jax.sharding.Mesh`` and lets GSPMD place the collectives; the port runs
one process per card (``parallel/launch.py``) and makes every reduction
explicit (``parallel/collectives.py``).  A ``Mesh`` here is only the layout:
the axis names and sizes, with the ranks laid out row-major over
``shape`` as ``np.reshape`` lays out JAX's device list, so the first axis
is the outermost.

  * ``"data"``: the batch axis; every rank holds ``1/d`` of the dataset
    and of each batch.
  * ``"dcn"``: the outer batch axis (one index per node).  The batch
    splits over ``("dcn", "data")`` together, ``"dcn"`` outermost, as
    ``batch_spec``'s ``P(("dcn", "data"))`` splits it in the JAX package.
    ``_hybrid_mesh`` (its slice-aware device order) has no counterpart
    beyond that rank order: ``torchrun`` numbers the ranks node by node, so
    a ``("dcn", "data")`` mesh with one ``dcn`` index per node keeps the
    ``"data"`` axis inside a node.
  * ``"model"``: the branch axis.  Branch parallelism is not ported yet
    (ROADMAP A.6b), so a mesh whose non-batch axes hold more than one
    device raises.
"""
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

#: mesh axes a batch dimension shards over, outermost first
BATCH_AXES = ("dcn", "data")


def parse_axis_spec(value, cast=int) -> Tuple:
    """Accept a tuple/list or a CLI string like "2,4" / "model,data"."""
    if isinstance(value, str):
        return tuple(cast(v.strip()) for v in value.split(",") if v.strip())
    if isinstance(value, (int, float)):
        return (cast(value),)
    return tuple(cast(v) for v in value)


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; rank r sits at ``np.unravel_index(r, sizes)``."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Number of devices (processes)."""
        return int(np.prod(self.sizes))

    def coords(self, rank) -> dict:
        """{axis name: index} of ``rank``."""
        return dict(zip(self.axis_names,
                        (int(i) for i in np.unravel_index(rank, self.sizes))))

    def batch_group(self, rank) -> list:
        """The ranks that share ``rank``'s non-batch coordinates: the
        processes among which a batch is split."""
        mine = self.coords(rank)
        return [r for r in range(self.size)
                if all(self.coords(r)[a] == mine[a]
                       for a in self.axis_names if a not in BATCH_AXES)]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axes: Tuple[str, ...] = ("data",), n_devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``; ``shape=None`` puts
    ``n_devices`` on the first axis.  Raises for a non-batch axis of more
    than one device."""
    if shape is None:
        n = local_mesh_size() if n_devices is None else n_devices
        shape, axes = (n,), tuple(axes)[:1]
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh_shape {shape} and mesh_axes {axes} differ "
                         "in length")
    for a, s in zip(axes, shape):
        if a not in BATCH_AXES and s > 1:
            raise ValueError(
                f"mesh axis {a!r} of size {s}: the port splits only the "
                f"batch, over {BATCH_AXES}; branch parallelism over the "
                "'model' axis is not ported yet (ROADMAP A.6b)")
    return Mesh(axes, shape)


def build_mesh(cfg, n_devices=None) -> Optional[Mesh]:
    """Mesh for the entry points, from ``cfg.mesh_shape``/``mesh_axes``
    (the rules of ``ubpl_tpu/parallel/mesh.py:build_mesh``).

    ``mesh_shape`` None: all ``n_devices`` (default ``local_mesh_size()``)
    on a ``("data",)`` axis, shrunk to the largest count that divides
    ``train_bs``; None on one device.  An explicit ``mesh_shape`` always
    wins, and raises when it needs more than ``n_devices``."""
    n_devices = local_mesh_size() if n_devices is None else int(n_devices)
    if cfg.mesh_shape is None:
        if n_devices <= 1:
            return None
        n = n_devices
        bs = int(getattr(cfg, "train_bs", 0) or 0)
        if bs > 0:
            while n > 1 and bs % n != 0:
                n -= 1
        if n < n_devices:
            import warnings
            warnings.warn(
                f"auto mesh shrunk to {n} of {n_devices} local devices: "
                f"train_bs={bs} is not divisible by the device count; set "
                "train_bs to a multiple of it (or mesh_shape explicitly) to "
                "use every chip")
        if n <= 1:
            return None
        return make_mesh((n,), ("data",))
    shape = parse_axis_spec(cfg.mesh_shape, int)
    axes = parse_axis_spec(cfg.mesh_axes, str)
    need = int(np.prod(shape))
    if need > n_devices:
        raise ValueError(f"mesh_shape {shape} needs {need} devices, "
                         f"have {n_devices}")
    return make_mesh(shape, axes)


def batch_axes(mesh: Optional[Mesh]) -> Tuple[str, ...]:
    """The batch axes present in ``mesh``, outermost first; () without."""
    if mesh is None:
        return ()
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


def batch_mult(mesh: Optional[Mesh]) -> int:
    """Total ways the batch splits (dataset and batch sizes are padded or
    must be multiples of it)."""
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def batch_shard(mesh: Optional[Mesh], rank) -> int:
    """Index of ``rank``'s shard of a batch: row-major over the batch axes
    in ``BATCH_AXES`` order, whatever their order in the mesh."""
    if mesh is None:
        return 0
    coords = mesh.coords(rank)
    index = 0
    for a in batch_axes(mesh):
        index = index * mesh.shape[a] + coords[a]
    return index


def batch_rows(mesh: Optional[Mesh], rank, n) -> range:
    """The contiguous rows of an ``n``-row batch that ``rank`` holds: the
    shard ``batch_spec``'s ``P(("dcn", "data"))`` gives the device."""
    d = batch_mult(mesh)
    if n % d:
        raise ValueError(f"{n} rows do not split over the batch mesh axes "
                         f"{batch_axes(mesh)} (x{d})")
    lo = batch_shard(mesh, rank) * (n // d)
    return range(lo, lo + n // d)


def local_mesh_size() -> int:
    """The cards of this host."""
    return torch.cuda.device_count()
