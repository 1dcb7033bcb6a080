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
  * ``"model"``: the branch axis of the two-network regimes (MT_UBPL,
    DualPose(_UBPL)).  Model index ``i`` holds branches ``i * n_branch /
    model`` to ``(i + 1) * n_branch / model - 1`` (``local_branches``),
    each on the whole of its batch slice, as ``make_branch_forward``'s
    ``shard_map`` over ``"model"`` runs them (``ubpl_tpu/train/
    base_trainer.py:232-379``).  A regime without a branch axis runs whole
    on every model index, as the JAX package's replicated state does.

A rank belongs to two groups: its batch group (``Mesh.batch_group``: the
ranks with its ``model`` index, which split each batch) and its branch
group (``Mesh.branch_group``: the ranks with its batch coordinates, which
split the branches).
"""
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

#: mesh axes a batch dimension shards over, outermost first
BATCH_AXES = ("dcn", "data")
#: the mesh axis the stacked branches shard over
MODEL_AXIS = "model"


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

    def _sharing(self, rank, axes) -> list:
        mine = self.coords(rank)
        return [r for r in range(self.size)
                if all(self.coords(r)[a] == mine[a] for a in axes)]

    def batch_group(self, rank) -> list:
        """The ranks that share ``rank``'s non-batch coordinates: the
        processes among which a batch is split."""
        return self._sharing(rank, [a for a in self.axis_names
                                    if a not in BATCH_AXES])

    def branch_group(self, rank) -> list:
        """The ranks that share ``rank``'s batch coordinates: the processes
        among which the branches are split, in ``model`` order."""
        return self._sharing(rank, batch_axes(self))


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axes: Tuple[str, ...] = ("data",), n_devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``; ``shape=None`` puts
    ``n_devices`` on the first axis.  Raises for an axis other than
    ``"dcn"``, ``"data"`` and ``"model"`` of more than one device."""
    if shape is None:
        n = local_mesh_size() if n_devices is None else n_devices
        shape, axes = (n,), tuple(axes)[:1]
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh_shape {shape} and mesh_axes {axes} differ "
                         "in length")
    for a, s in zip(axes, shape):
        if a not in BATCH_AXES + (MODEL_AXIS,) and s > 1:
            raise ValueError(
                f"mesh axis {a!r} of size {s}: the port splits the batch "
                f"over {BATCH_AXES} and the branches over {MODEL_AXIS!r}")
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


def model_size(mesh: Optional[Mesh]) -> int:
    """Ways the branches split (1 without a ``model`` axis)."""
    return 1 if mesh is None else mesh.shape.get(MODEL_AXIS, 1)


def branch_shard(mesh: Optional[Mesh], rank) -> int:
    """``rank``'s index on the ``model`` axis (0 without one)."""
    if mesh is None or MODEL_AXIS not in mesh.axis_names:
        return 0
    return mesh.coords(rank)[MODEL_AXIS]


def local_branches(mesh: Optional[Mesh], rank, n_branch) -> range:
    """The branches of an ``n_branch`` axis that ``rank`` holds: branch
    ``i`` lives on model index ``i // (n_branch / model)``.  Raises the JAX
    package's ``ValueError`` when ``model`` does not divide ``n_branch``
    (``ubpl_tpu/train/base_trainer.py:346-349``)."""
    m_size = model_size(mesh)
    if n_branch % m_size != 0:
        raise ValueError(f"branch axis {n_branch} not divisible by "
                         f"'model' mesh axis ({m_size})")
    per = n_branch // m_size
    lo = branch_shard(mesh, rank) * per
    return range(lo, lo + per)


def local_mesh_size() -> int:
    """The cards of this host."""
    return torch.cuda.device_count()
