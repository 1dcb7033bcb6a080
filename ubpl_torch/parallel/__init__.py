"""Data-parallel training over several devices: the counterpart of
``ubpl_tpu/parallel/`` (``mesh.py``: the layout; ``collectives.py``: the
reductions GSPMD inserts in the JAX package; ``launch.py``: one process per
card, ``launch.launch``)."""
from .mesh import (BATCH_AXES, Mesh, batch_axes, batch_mult, batch_rows,
                   build_mesh, local_mesh_size, make_mesh, parse_axis_spec)

__all__ = ["BATCH_AXES", "Mesh", "batch_axes", "batch_mult", "batch_rows",
           "build_mesh", "local_mesh_size", "make_mesh", "parse_axis_spec"]
