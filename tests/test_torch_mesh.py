"""``ubpl_torch.parallel.build_mesh`` against ``ubpl_tpu.parallel.build_mesh``
on the same ``Config``s, over conftest's 8 virtual CPU devices.

For each case both are built for the same number of devices and compared:
None or not, shape, axis names, ``batch_axes``, ``batch_mult``, the auto
mesh's warning, and each rank's ``batch_rows`` against the rows that the
device at the same place in JAX's mesh holds of an array laid out with
``batch_spec`` (``NamedSharding.devices_indices_map``, no program is
compiled).  A mesh that needs more devices than there are raises in both.
On meshes with a ``model`` axis the port's rank coordinates, batch groups
and branch groups are the JAX mesh's (``test_model_axis_matches_jax``), and
a ``model`` axis that does not divide the two branches raises JAX's
``ValueError``.
"""
from types import SimpleNamespace
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
    (8, {"mesh_shape": (4, 2), "mesh_axes": ("data", "model")}),
    (8, {"mesh_shape": (4,), "mesh_axes": ("model",)}),
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
    _assert_rows_match(jmesh, tmesh)


def _assert_rows_match(jmesh, tmesh):
    """Each rank's ``batch_rows`` are the rows that the device at its place
    in JAX's mesh holds of an array laid out with ``batch_spec``."""
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


def _jax_groups(jmesh, rank_of, keep):
    """For each device of ``jmesh`` (in rank order), the ranks of the
    devices that share its coordinates on the axes ``keep`` names."""
    names = jmesh.axis_names
    at = {rank_of[d]: c for c, d in np.ndenumerate(jmesh.devices)}
    return [sorted(r for r, c in at.items()
                   if all(c[i] == at[rank][i] for i, a in enumerate(names)
                          if keep(a)))
            for rank in range(len(at))]


@pytest.mark.parametrize("n,kw", MODEL_AXIS, ids=_ids(MODEL_AXIS))
def test_model_axis_matches_jax(n, kw):
    """JAX shards its branch axis over ``model``: the port's mesh has the
    same axis sizes, each rank the coordinates of the device at its place
    in JAX's mesh, its batch group the devices with its ``model`` index
    and its branch group those with its batch coordinates."""
    (jmesh, _), (tmesh, _) = _build(n, kw)
    assert tmesh.shape == dict(jmesh.shape) and tmesh.shape["model"] > 1
    rank_of = {d: r for r, d in enumerate(jmesh.devices.flat)}
    for c, d in np.ndenumerate(jmesh.devices):
        assert tuple(tmesh.coords(rank_of[d]).values()) == c
    batch = _jax_groups(jmesh, rank_of, lambda a: a not in JM.BATCH_AXES)
    branch = _jax_groups(jmesh, rank_of, lambda a: a in JM.BATCH_AXES)
    for rank in range(tmesh.size):
        assert tmesh.batch_group(rank) == batch[rank]
        assert tmesh.branch_group(rank) == branch[rank]
    _assert_rows_match(jmesh, tmesh)


@pytest.mark.parametrize("n,kw", MODEL_AXIS, ids=_ids(MODEL_AXIS))
def test_branch_split_matches_jax(n, kw):
    """Two branches over ``model``: each model index holds
    ``n_branch / model`` of them, or both raise JAX's ``ValueError``
    (``make_branch_forward``, reached here without building a step)."""
    import ubpl_tpu.train.base_trainer as JB
    (jmesh, _), (tmesh, _) = _build(n, kw)
    fake = SimpleNamespace(mesh=jmesh, cfg=SimpleNamespace(remat=False),
                           n_models=2)
    if 2 % jmesh.shape["model"]:
        with pytest.raises(ValueError) as theirs:
            JB.BaseTrainer.make_branch_forward(fake, None, None)
        with pytest.raises(ValueError) as ours:
            TM.local_branches(tmesh, 0, 2)
        assert str(ours.value) == str(theirs.value)
        return
    JB.BaseTrainer.make_branch_forward(fake, None, None)
    for rank in range(tmesh.size):
        m = tmesh.coords(rank)["model"]
        assert TM.local_branches(tmesh, rank, 2) == range(m, m + 1)


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
    assert mesh.branch_group(4) == [4]
    assert [TM.batch_rows(mesh, r, 12).start for r in range(6)] == [
        0, 2, 4, 6, 8, 10]


def test_batch_rows_refuses_a_ragged_split():
    with pytest.raises(ValueError, match="do not split"):
        TM.batch_rows(TM.make_mesh((4,)), 0, 6)


def test_no_mesh_holds_every_row():
    assert TM.batch_rows(None, 0, 7) == range(7)
    assert TM.batch_mult(None) == 1 and TM.batch_axes(None) == ()
    assert TM.local_branches(None, 0, 2) == range(2)


def test_other_axes_are_refused():
    """Axes other than dcn, data and model split nothing in the port."""
    with pytest.raises(ValueError, match="'stage' of size 2"):
        TM.make_mesh((2, 2), ("stage", "data"))


def test_make_mesh_defaults_to_the_local_cards():
    """The port's local devices are the cards; shape None puts them all on
    the first axis."""
    assert TM.local_mesh_size() == torch.cuda.device_count()
    assert TM.make_mesh(None, ("data", "model"), n_devices=3).shape == {
        "data": 3}
