"""The port's own copies of the host-side schedule and sampler code against
the reference goldens (``tests/goldens/schedules.npz``) and the JAX
package's modules: plain floats and numpy index arrays, so equality is
exact (goldens: rtol 1e-8, as ``test_losses_parity.py``)."""
import numpy as np
import pytest

from ubpl_torch.config import Config
from ubpl_torch.data.sampler import (TwoStreamBatchSampler,
                                     supervised_epoch_batches, valid_batches)
from ubpl_torch.train import schedules as S
from ubpl_tpu.data import sampler as JSampler
from ubpl_tpu.train import schedules as JS

EPOCHS = range(0, 121)


@pytest.mark.parametrize("name,key", [("cons_weight", "cons"),
                                      ("pseudo_weight", "pseudo"),
                                      ("fdl_weight", "fdl"),
                                      ("ema_alpha", "alpha")])
def test_schedule_matches_golden(goldens, name, key):
    """Reference defaults, every epoch of the golden: rtol 1e-8."""
    g = goldens("schedules")
    for e in g["epochs"]:
        np.testing.assert_allclose(getattr(S, name)(int(e)), g[key][int(e)],
                                   rtol=1e-8)


@pytest.mark.parametrize("name,args", [
    ("sigmoid_rampup", (30,)),
    ("sigmoid_rampup", (0,)),
    ("value_increase", (10.0, 0.5, 40)),
    ("value_decrease", (10.0, 0.5, 40)),
    ("cons_weight", (10.0, 0.0, 5)),
    ("pseudo_weight", (1.0, 0.2, 100)),
    ("fdl_weight", (1.0, 0.1, 100)),
    ("ema_alpha", (0.999,)),
    ("ema_alpha", (0.9,)),
    ("step_schedule", ([10, 40, 80], [1.0, 0.2, 0.6], 120)),
    ("step_schedule", ([0, 50], [0.3, 1.0], 200)),
    ("cawr_schedule", ([30, 60, 200], [1.0, 0.7, 0.4, 0.2], 0.05)),
])
def test_schedule_matches_jax(name, args):
    """Same floats as the JAX package's function over epochs 0-120."""
    for e in EPOCHS:
        assert getattr(S, name)(e, *args) == getattr(JS, name)(e, *args), e


def test_ssl_epoch_schedules_match_jax():
    """ssl_epoch_schedules on a non-default config: equal dicts over epochs
    0-120; at epoch 0 the EMA weight is 0 (the teacher becomes the
    student)."""
    from ubpl_tpu.config import Config as JConfig
    kw = dict(cons_weight_max=20.0, cons_weight_min=1.0, cons_weight_rampup=7,
              fdl_weight_max=2.0, fdl_weight_min=0.5, fdl_weight_rampup=30,
              pseudo_weight_max=3.0, pseudo_weight_min=0.1,
              pseudo_weight_rampup=50, ema_decay=0.99)
    ours, theirs = Config(**kw), JConfig(**kw)
    for e in EPOCHS:
        assert S.ssl_epoch_schedules(ours, e) == JS.ssl_epoch_schedules(
            theirs, e)
    assert S.ssl_epoch_schedules(ours, 0)["ema_alpha"] == 0.0
    assert S.ssl_epoch_schedules(ours, 1)["ema_alpha"] == 0.5


@pytest.mark.parametrize("seed", [0, 7, 1388])
def test_two_stream_sampler_matches_jax(seed):
    """Same seed, same batches as the JAX package's sampler, over three
    epochs of one generator (the labeled stream reshuffles and cycles)."""
    prim, sec = list(range(10, 41)), list(range(0, 10))
    ours = TwoStreamBatchSampler(prim, sec, 8, 3,
                                 np.random.default_rng(seed))
    theirs = JSampler.TwoStreamBatchSampler(prim, sec, 8, 3,
                                            np.random.default_rng(seed))
    assert len(ours) == len(theirs) == 6
    for _ in range(3):
        a, b = list(ours), list(theirs)
        assert len(a) == 6
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_two_stream_sampler_layout():
    """Unlabeled first, then labeled; the unlabeled stream is one pass
    without repeats; the labeled stream cycles when it is the shorter."""
    prim, sec = list(range(100, 120)), list(range(0, 3))
    batches = list(TwoStreamBatchSampler(prim, sec, 6, 2,
                                         np.random.default_rng(1)))
    assert len(batches) == 5
    seen = np.concatenate([b[:4] for b in batches])
    assert sorted(seen) == prim
    labeled = np.concatenate([b[4:] for b in batches])
    assert set(labeled) == set(sec) and len(labeled) == 10


@pytest.mark.parametrize("seed", [0, 7, 1388])
def test_supervised_and_valid_batches_match_jax(seed):
    """The supervised and validation batch generators, held to the JAX
    package's."""
    a = supervised_epoch_batches(list(range(23)), 4,
                                 np.random.default_rng(seed))
    b = JSampler.supervised_epoch_batches(list(range(23)), 4,
                                          np.random.default_rng(seed))
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(valid_batches(11, 4), JSampler.valid_batches(11, 4)):
        np.testing.assert_array_equal(x, y)
