"""``ubpl_torch.parallel.build_mesh`` against ``ubpl_tpu.parallel.build_mesh``
on the same ``Config``s, over conftest's 8 virtual CPU devices.

For each case both are built for the same number of devices and compared:
None or not, shape, axis names, ``batch_axes``, ``batch_mult``, the auto
mesh's warning, and each rank's ``batch_rows`` against the rows that the
device at the same place in JAX's mesh holds of an array laid out with
``batch_spec`` (``NamedSharding.devices_indices_map``, no program is
compiled).  A mesh that needs more devices than there are raises in both;
a ``model`` axis larger than 1 is built by JAX and refused by the port
(ROADMAP A.6b).
"""
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from ubpl_torch import parallel as TP
from ubpl_torch.config import Config as TConfig
from ubpl_torch.parallel import mesh as TM
from ubpl_tpu import parallel as JP
from ubpl_tpu.config import Config as JConfig
from ubpl_tpu.parallel import mesh as JM

ROWS = 48               # a dataset length every batch_mult below divides

# (n_devices, config overrides)
CASES = [
    (8, {}),                                       # auto: all 8 (bs 4 -> 4)
    (8, {"train_bs": 8}),
    (8, {"train_bs": 4}),                          # auto shrinks to 4
    (8, {"train_bs": 6}),                          # ... to 6
    (8, {"train_bs": 1}),                          # ... to 1: no mesh
    (8, {"train_bs": 12}),                         # ... to 6
    (3, {"train_bs": 4}),                          # 3 devices: 2
    (1, {}),                                       # one device: no mesh
    (2, {"train_bs": 32}),
    (8, {"mesh_shape": (2,)}),                     # explicit wins
    (8, {"mesh_shape": (8,), "train_bs": 4}),      # ... over the batch too
    (8, {"mesh_shape": (1,)}),
    (8, {"mesh_shape": "4"}),                      # the CLI's string form
    (8, {"mesh_shape": (2, 4), "mesh_axes": ("dcn", "data")}),
    (8, {"mesh_shape": "2,2", "mesh_axes": "dcn,data"}),
    (8, {"mesh_shape": (2, 1), "mesh_axes": ("dcn", "data")}),
    (8, {"mesh_shape": (1, 2), "mesh_axes": ("dcn", "data")}),
    (8, {"mesh_shape": (2, 2), "mesh_axes": ("data", "dcn")}),  # dcn inner
    (8, {"mesh_shape": (1, 4), "mesh_axes": ("model", "data")}),
    (8, {"mesh_shape": (2, 1, 2), "mesh_axes": ("dcn", "model", "data")}),
]
TOO_MANY = [
    (8, {"mesh_shape": (16,)}),
    (2, {"mesh_shape": (4,)}),
    (8, {"mesh_shape": (4, 4), "mesh_axes": ("dcn", "data")}),
]
MODEL_AXIS = [
    (8, {"mesh_shape": (2, 4), "mesh_axes": ("model", "data")}),
    (8, {"mesh_shape": (2,), "mesh_axes": ("model",)}),
    (8, {"mesh_shape": (2, 2, 2), "mesh_axes": ("dcn", "model", "data")}),
]


def _cfgs(kw):
    return JConfig().override(dict(kw)), TConfig().override(dict(kw))


def _build(n, kw):
    """Both meshes over n devices, with the warnings each gave."""
    jcfg, tcfg = _cfgs(kw)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jmesh = JP.build_mesh(jcfg, jax.devices()[:n])
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tmesh = TP.build_mesh(tcfg, n)
    return (jmesh, [str(w.message) for w in jw]), (
        tmesh, [str(w.message) for w in tw])


def _ids(cases):
    return [f"{n}dev-" + "-".join(f"{k}={v}" for k, v in kw.items())
            for n, kw in cases]


@pytest.mark.parametrize("n,kw", CASES, ids=_ids(CASES))
def test_build_mesh_matches_jax(n, kw):
    (jmesh, jwarn), (tmesh, twarn) = _build(n, kw)
    assert twarn == jwarn
    if jmesh is None:
        assert tmesh is None
        return
    assert tmesh.shape == dict(jmesh.shape)
    assert tmesh.axis_names == tuple(jmesh.axis_names)
    assert tmesh.size == jmesh.devices.size
    assert TM.batch_axes(tmesh) == JM.batch_axes(jmesh)
    assert TM.batch_mult(tmesh) == JM.batch_mult(jmesh)
    held = NamedSharding(jmesh, JM.batch_spec(jmesh, 1)).devices_indices_map(
        (ROWS,))
    for rank, device in enumerate(jmesh.devices.flat):
        want = held[device][0]
        got = TM.batch_rows(tmesh, rank, ROWS)
        assert (got.start, got.stop) == (want.start or 0,
                                         ROWS if want.stop is None
                                         else want.stop), (rank, device)


@pytest.mark.parametrize("n,kw", TOO_MANY, ids=_ids(TOO_MANY))
def test_build_mesh_too_few_devices_raises(n, kw):
    jcfg, tcfg = _cfgs(kw)
    with pytest.raises(ValueError, match="needs") as theirs:
        JP.build_mesh(jcfg, jax.devices()[:n])
    with pytest.raises(ValueError, match="needs") as ours:
        TP.build_mesh(tcfg, n)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("n,kw", MODEL_AXIS, ids=_ids(MODEL_AXIS))
def test_model_axis_refused_naming_the_roadmap(n, kw):
    """JAX shards its branch axis over ``model``; the port refuses until
    branch parallelism is ported."""
    jcfg, tcfg = _cfgs(kw)
    assert JP.build_mesh(jcfg, jax.devices()[:n]).shape["model"] > 1
    with pytest.raises(ValueError, match="ROADMAP A.6b"):
        TP.build_mesh(tcfg, n)


@pytest.mark.parametrize("value,cast", [("2,4", int), ("model, data", str),
                                        (3, int), ((1, 2), int),
                                        (["dcn", "data"], str)])
def test_parse_axis_spec_matches_jax(value, cast):
    assert TM.parse_axis_spec(value, cast) == JM.parse_axis_spec(value, cast)


def test_mesh_layout_is_row_major():
    """Rank r sits where np.reshape puts device r: the first axis is the
    outermost; a batch group spans the batch axes."""
    mesh = TM.make_mesh((2, 3), ("dcn", "data"))
    assert [tuple(mesh.coords(r).values()) for r in range(6)] == [
        tuple(int(i) for i in c) for c in np.ndindex(2, 3)]
    assert mesh.batch_group(4) == list(range(6))
    assert [TM.batch_rows(mesh, r, 12).start for r in range(6)] == [
        0, 2, 4, 6, 8, 10]


def test_batch_rows_refuses_a_ragged_split():
    with pytest.raises(ValueError, match="do not split"):
        TM.batch_rows(TM.make_mesh((4,)), 0, 6)


def test_no_mesh_holds_every_row():
    assert TM.batch_rows(None, 0, 7) == range(7)
    assert TM.batch_mult(None) == 1 and TM.batch_axes(None) == ()


def test_make_mesh_defaults_to_the_local_cards():
    """The port's local devices are the cards; shape None puts them all on
    the first axis."""
    assert TM.local_mesh_size() == torch.cuda.device_count()
    assert TM.make_mesh(None, ("data", "model"), n_devices=3).shape == {
        "data": 3}
