"""Training over several devices, data and branch parallel: the
counterpart of ``ubpl_tpu/parallel/`` (``mesh.py``: the layout;
``collectives.py``: the reductions and exchanges GSPMD inserts in the JAX
package; ``launch.py``: one process per card, ``launch.launch``)."""
from .mesh import (BATCH_AXES, MODEL_AXIS, Mesh, batch_axes, batch_mult,
                   batch_rows, build_mesh, local_branches, local_mesh_size,
                   make_mesh, model_size, parse_axis_spec)

__all__ = ["BATCH_AXES", "MODEL_AXIS", "Mesh", "batch_axes", "batch_mult",
           "batch_rows", "build_mesh", "local_branches", "local_mesh_size",
           "make_mesh", "model_size", "parse_axis_spec"]
