"""Port model and weight carrier (``ubpl_torch.models``) against the
reference golden and the JAX package's mapping.

Fixture: tests/goldens/torch_import_hg2.npz — a reference StackedHourglass
(HG2, k=5, AvgPool) state_dict with moved BN running stats, plus its
eval-mode forward on a fixed input.
"""
import copy
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubpl_tpu.models.torch_import import hourglass_entries as jax_entries
from ubpl_tpu.models.torch_import import import_hourglass

from ubpl_torch.config import Config
from ubpl_torch.models import create_pose_model, param_count
from ubpl_torch.models.hourglass import FEATURE_MODES
from ubpl_torch.models.layers import BatchNorm
from ubpl_torch.models.weights import (checkpoint_state_key,
                                       hourglass_entries,
                                       load_reference_checkpoint, load_state,
                                       state_dict_from_jax)
from ubpl_torch.train.common import make_view
from ubpl_torch.train.supervised import supervised_step

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "torch_import_hg2.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on one host: torch's intra-op
    threads would oversubscribe the cores (measured 2 s -> 57 s for one
    step under six workers), so this module computes single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden():
    g = np.load(GOLDEN)
    sd = {k[4:]: g[k] for k in g.files if k.startswith("sd::")}
    return g, sd, int(g["k"]), int(g["n_stack"])


def _live(sd):
    """The golden state_dict without what the port drops: the never-run
    same-width skip convs and num_batches_tracked."""
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        if ".skip_layer." in k:
            w = sd[k[:k.index(".skip_layer.")] + ".skip_layer.conv.weight"]
            if w.shape[0] == w.shape[1]:
                continue
        out[k] = v
    return out


def test_golden_eval_forward_via_checkpoint_loader(tmp_path):
    """A reference .pth.tar loaded through the port's loader reproduces the
    reference eval forward: preds and feats at rtol 1e-4 / atol 2e-4."""
    g, sd, k, n_stack = _golden()
    path = str(tmp_path / "checkpoint.pth.tar")
    torch.save({"current_epoch": 4, "model_state":
                {key: torch.from_numpy(np.array(v)) for key, v in sd.items()}},
               path)
    state, meta = load_reference_checkpoint(path)
    assert meta["source_key"] == "model_state" and meta["current_epoch"] == 4
    model = load_state(create_pose_model(f"HG{n_stack}", k), state).eval()
    with torch.no_grad():
        preds, feats = model(torch.as_tensor(g["input"]))
    np.testing.assert_allclose(preds.numpy(), g["preds"], rtol=1e-4,
                               atol=2e-4)
    np.testing.assert_allclose(feats.numpy(), g["feats"], rtol=1e-4,
                               atol=2e-4)


def test_state_dict_from_jax_reproduces_golden():
    """JAX-package params (from its numpy-only import) carried back into the
    port reproduce the golden state_dict exactly, under the same keys."""
    g, sd, k, n_stack = _golden()
    params, stats = import_hourglass(sd, n_stack)
    ours = state_dict_from_jax(params, stats, n_stack)
    live = _live(sd)
    assert set(ours) == set(live)
    for key, v in live.items():
        np.testing.assert_array_equal(ours[key].numpy(), v, err_msg=key)
    model = create_pose_model(f"HG{n_stack}", k)
    assert set(ours) == set(model.state_dict())


@pytest.mark.parametrize("mode", FEATURE_MODES)
def test_mapping_table_covers_model(mode):
    """The port's copy of the mapping table names exactly the port model's
    state_dict (every mode), and equals the JAX package's table where the
    reference has the keys (all but the port-only ConvOne projection)."""
    ours = hourglass_entries(2, mode)
    model = create_pose_model("HG2", 5, mode)
    assert {e[2] for e in ours} == set(model.state_dict())
    assert [e for e in ours if not e[2].startswith("project.")] == \
        jax_entries(2, mode)


@pytest.mark.parametrize("mode", FEATURE_MODES)
def test_feature_modes_shapes(mode):
    """[B, S, K, H, W] heatmap stacks; features [B, S, 256, H/2, W/2] from
    the pooling modes, [B, S, 256, H, W] from the 1x1 ConvOne projection
    (as in the JAX package), none for "default"."""
    model = create_pose_model("HG2", 5, mode).eval()
    with torch.no_grad():
        out = model(torch.zeros((2, 3, 64, 64)))
    if mode == "default":
        assert out.shape == (2, 2, 5, 16, 16)
    else:
        side = 16 if mode == "ConvOne" else 8
        assert out[0].shape == (2, 2, 5, 16, 16)
        assert out[1].shape == (2, 2, 256, side, side)


@pytest.mark.parametrize("model_type,count", [("HG2", 6_565_010),
                                              ("HG3", 9_705_371)])
def test_param_counts(model_type, count):
    """Used-parameter counts of the reference models at K=9 (README
    "Parity"): no dead skip convs."""
    assert param_count(create_pose_model(model_type, 9)) == count


def test_load_state_rejects_mismatch():
    model = create_pose_model("HG2", 5)
    sd = model.state_dict()
    with pytest.raises(KeyError):
        load_state(model, {k: v for k, v in sd.items()
                           if k != "pre.0.bn.bias"})
    with pytest.raises(KeyError):
        load_state(model, dict(sd, extra=torch.zeros(1)))
    # the port-only ConvOne projection may be absent (reference checkpoints)
    conv_one = create_pose_model("HG2", 5, "ConvOne")
    load_state(conv_one, {k: v for k, v in conv_one.state_dict().items()
                          if not k.startswith("project.")})


def test_checkpoint_state_key_layouts():
    """Reference layouts: model{b}[_ema]_state, model[_ema]_state,
    model_state; head="ema" prefers the teacher."""
    dual = ["model1_state", "model1_ema_state", "model2_state",
            "model2_ema_state"]
    assert checkpoint_state_key(dual, 2, "ema") == "model2_ema_state"
    assert checkpoint_state_key(dual, 1, "student") == "model1_state"
    assert checkpoint_state_key(["model_state", "model_ema_state"]) == \
        "model_ema_state"
    assert checkpoint_state_key(["model_state"], 2, "ema") == "model_state"
    with pytest.raises(KeyError):
        checkpoint_state_key(["optimizer"])


def test_batchnorm_biased_running_var_matches_flax():
    """Train-mode BN: output and running stats equal flax
    nn.BatchNorm(momentum=0.9), which moves running_var towards the biased
    batch variance (n=2 values per channel here: torch's BatchNorm2d would
    be off by a factor of 2 in the update).  rtol 1e-6."""
    x = np.random.default_rng(0).normal(size=(2, 1, 1, 4)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    ours = BatchNorm(4).train()
    out = ours(torch.as_tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=1e-6, atol=1e-6)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=1e-6)
    biased = x.reshape(2, 4).var(0)
    np.testing.assert_allclose(ours.running_var.numpy(), 0.9 + 0.1 * biased,
                               rtol=1e-6)


def test_remat_step_is_identical():
    """Config.remat (torch.utils.checkpoint) gives the same step: loss,
    parameters and BN running stats bit-identical — the recomputed forward
    does not update the running stats a second time."""
    cfg = Config(model="HG2", inp_res=64, out_res=16, kps_count=5,
                 compute_dtype="float32")
    torch.manual_seed(0)
    base = create_pose_model("HG2", 5)
    rng = np.random.default_rng(2)
    imgs = torch.as_tensor(rng.integers(0, 256, (2, 64, 64, 3), np.uint8))
    kps = torch.as_tensor(np.concatenate(
        [rng.uniform(8, 56, (2, 5, 2)), np.ones((2, 5, 1))], -1
    ).astype(np.float32))
    view = make_view(imgs, kps, torch.full((3,), 0.5), cfg)
    results = []
    for remat in (False, True):
        model = copy.deepcopy(base)
        opt = torch.optim.AdamW(model.parameters(), lr=cfg.lr,
                                weight_decay=0.0)
        cfg.remat = remat
        m = supervised_step(model, opt, view, cfg)
        results.append((m["pec_loss"], model.state_dict()))
    assert torch.equal(results[0][0], results[1][0])
    for key, v in results[0][1].items():
        assert torch.equal(v, results[1][1][key]), key
