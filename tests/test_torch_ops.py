"""Port ops (``ubpl_torch.ops``, ``ubpl_torch.train.losses``) against the
reference goldens and the JAX package on the same inputs.

JAX arrays are channel-last ([..., H, W, K] / [B, H, W, C]); the port is
NCHW, so JAX outputs are transposed before comparing.  Inputs are made with
numpy from fixed seeds and handed to both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubpl_tpu.ops import augment as JA
from ubpl_tpu.ops import heatmap as JHM
from ubpl_tpu.ops import transforms as JT
from ubpl_tpu.ops.pallas import synthesize_heatmaps_pallas
from ubpl_tpu.train import losses as JL

from ubpl_torch.ops import augment as A
from ubpl_torch.ops import heatmap as HM
from ubpl_torch.ops import pck as PCK
from ubpl_torch.ops import transforms as T
from ubpl_torch.ops.kernels import heatmap_synth as HS
from ubpl_torch.train import losses as L


def t32(x):
    return torch.as_tensor(np.array(x, np.float32))


def nchw(x):
    return np.moveaxis(np.asarray(x), -1, -3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on one host: torch's intra-op
    threads would oversubscribe the cores (measured 2 s -> 57 s for one
    step under six workers), so this module computes single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- transforms

def test_transform_matrix_and_points(goldens):
    """Goldens at the JAX package's tolerances: matrices rtol/atol 1e-5;
    truncated points within 1 px everywhere and exact on > 98%."""
    g = goldens("transform")
    res = tuple(g["res"])
    mats = T.get_transform_matrix(t32(g["centers"]), t32(g["scales"]), res,
                                  t32(g["rots"]))
    np.testing.assert_allclose(mats.numpy(), g["mats"], rtol=1e-5, atol=1e-5)
    outs = np.zeros_like(g["outs"])
    for inv in (0, 1):
        sel = g["invert"] == inv
        o = T.transform_points(t32(g["pts"][sel]), t32(g["centers"][sel]),
                               t32(g["scales"][sel]), res, invert=bool(inv),
                               rot=t32(g["rots"][sel]))
        outs[sel] = o.numpy()
    diff = np.abs(outs - g["outs"])
    assert (diff <= 1).all()
    assert (diff == 0).mean() > 0.98


def test_warpmat(goldens):
    """Reference warpmat with its double 1/scale: rtol 1e-5, atol 1e-6."""
    g = goldens("warpmat")
    wm = T.affine_warpmat(t32(g["angles"]), t32(g["scales"]))
    np.testing.assert_allclose(wm.numpy(), g["warpmats"], rtol=1e-5,
                               atol=1e-6)


def test_transform_preds_matches_jax():
    """Decode-side inverse transform: float32 in both, exact."""
    rng = np.random.default_rng(3)
    coords = rng.integers(1, 17, (3, 5, 2)).astype(np.float32)
    center = rng.uniform(20, 40, (3, 2)).astype(np.float32)
    scale = rng.uniform(0.2, 0.4, (3,)).astype(np.float32)
    ref = JT.transform_preds(jnp.asarray(coords), jnp.asarray(center),
                             jnp.asarray(scale), (16, 16))
    got = T.transform_preds(t32(coords), t32(center), t32(scale), (16, 16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _warp_inputs(images, seed, sf=0.25, rf=30.0):
    rng = np.random.default_rng(seed)
    B, R = images.shape[0], images.shape[1]
    center = np.full((B, 2), R // 2, np.float32)
    scale = (R / 200.0 * np.clip(rng.normal(1, sf, B), 1 - sf, 1 + sf)
             ).astype(np.float32)
    angle = np.clip(rng.normal(0, rf, B), -rf, rf).astype(np.float32)
    mats = np.asarray(JT.affine_warp_matrix(jnp.asarray(center),
                                            jnp.asarray(scale),
                                            jnp.asarray(angle), (R, R)))
    return mats


def _gather_training_convention(imgs, mats, out_res):
    """JAX's exact gather sampler (``grid_sample_bilinear``, the core of
    ``warp_images_affine_gather``) at the training warp's source positions:
    output pixel p at ``inv(mat) @ (p - 1) + 1``, with the offsets folded
    in float32 as JAX's ``warp_images_affine`` folds them."""
    inv = JT.invert_affine3(jnp.asarray(mats))
    m00, m01, m02 = inv[:, 0, 0], inv[:, 0, 1], inv[:, 0, 2]
    m10, m11, m12 = inv[:, 1, 0], inv[:, 1, 1], inv[:, 1, 2]
    c0 = m02 - m00 - m01 + 1.0
    c1 = m12 - m10 - m11 + 1.0
    r = jnp.arange(out_res, dtype=jnp.float32)
    ys, xs = r[:, None], r[None, :]
    sx = (m00[:, None, None] * xs + m01[:, None, None] * ys
          + c0[:, None, None])
    sy = (m10[:, None, None] * xs + m11[:, None, None] * ys
          + c1[:, None, None])
    return jax.vmap(JT.grid_sample_bilinear)(jnp.asarray(imgs), sx, sy)


def test_warp_matches_jax_gather():
    """Exact bilinear warp with zero padding (grid_sample, align_corners)
    against JAX's gather warp sampler at the training path's 1-indexed
    source positions: atol 1e-5 on noise images."""
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    mats = _warp_inputs(imgs, 1)
    ref = _gather_training_convention(imgs, mats, 64)
    got = T.warp_images_affine(t32(nchw(imgs)), t32(mats), 64)
    np.testing.assert_allclose(got.numpy(), nchw(ref), atol=1e-5)


@pytest.mark.parametrize("scale,angle", [(1.0, 0.0), (0.75, 0.0),
                                         (1.25, 0.0), (1.0, 30.0),
                                         (0.8, -20.0), (1.1, 10.0)])
def test_warp_matches_jax_training_warp(scale, angle):
    """The port's warp against the JAX training path's warp_images_affine
    (two-pass tent matmul) on affine ramp images, where bilinear and
    two-pass linear interpolation are both exact: interior pixels (source
    within [1, R-2]) to 1e-4.  The port's former convention, sampling at
    ``inv @ p`` (the gather warp's), fails this by up to 5.2e-3 on these
    ramps (a 0.25-0.6 px shift at 0.01 per px) at every case but
    (1.0, 0.0)."""
    R = 64
    yy, xx = np.mgrid[0:R, 0:R].astype(np.float32)
    img = np.stack([0.01 * xx + 0.003 * yy, 0.5 - 0.004 * xx + 0.006 * yy,
                    0.2 + 0.002 * xx], -1)[None]
    mats = np.asarray(JT.affine_warp_matrix(
        jnp.full((1, 2), R // 2, jnp.float32),
        jnp.asarray([R / 200 * scale], jnp.float32),
        jnp.asarray([angle], jnp.float32), (R, R)))
    ref = np.asarray(JT.warp_images_affine(jnp.asarray(img),
                                           jnp.asarray(mats), R))[0]
    got = T.warp_images_affine(t32(nchw(img)), t32(mats), R).numpy()[0]
    inv = np.linalg.inv(mats[0].astype(np.float64))
    ys, xs = np.mgrid[0:R, 0:R] - 1.0
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2] + 1
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2] + 1
    interior = (sx >= 1) & (sx <= R - 2) & (sy >= 1) & (sy <= R - 2)
    assert interior.sum() > R * R / 2
    np.testing.assert_allclose(np.moveaxis(got, 0, -1)[interior],
                               ref[interior], atol=1e-4)


def test_warp_near_jax_two_pass():
    """Against the JAX training path's two-pass tent-matmul warp on a
    smooth 256^2 image with a moderate crop/rotation, borders included:
    the mean gap stays within the 0.002 recorded in docs/PERF.md "Warp
    optimization detail"."""
    R = 256
    yy, xx = np.mgrid[0:R, 0:R] / R
    blob = np.exp(-((xx - 0.5) ** 2 + (yy - 0.5) ** 2) / 0.1)
    imgs = np.repeat(blob[None, ..., None], 3, -1).repeat(2, 0
                                                          ).astype(np.float32)
    center = jnp.full((2, 2), R // 2, jnp.float32)
    scale = jnp.asarray([R / 200 * 1.1, R / 200 * 0.9], jnp.float32)
    angle = jnp.asarray([15.0, -15.0], jnp.float32)
    mats = JT.affine_warp_matrix(center, scale, angle, (R, R))
    ref = JT.warp_images_affine(jnp.asarray(imgs), mats, R)
    got = T.warp_images_affine(t32(nchw(imgs)), t32(mats), R)
    assert float(np.abs(got.numpy() - nchw(ref)).mean()) <= 0.002


# ------------------------------------------------------------------ heatmap

def test_synthesis_matches_golden(goldens):
    """Plain synthesis against the reference: maps atol 1e-5, kps_new 1e-4
    (the JAX package's tolerances)."""
    g = goldens("heatmap")
    hm, kps_new = HM.synthesize_heatmaps(t32(g["kps"]))
    np.testing.assert_allclose(hm.numpy(), g["heatmaps"], atol=1e-5)
    np.testing.assert_allclose(kps_new.numpy(), g["kps_new"], atol=1e-4)


@pytest.mark.parametrize("jax_fn", ["xla", "pallas_interpret"])
def test_synthesis_matches_jax(jax_fn):
    """kps from uniform(-5, 260) (negative and out-of-frame joints, so the
    trunc and the visibility re-gate are exercised): maps atol 1e-5,
    kps_new exact.  Both the XLA path and the Pallas kernel (interpret
    mode) of the JAX package."""
    kps = np.random.default_rng(0).uniform(-5, 260, (6, 9, 3)
                                           ).astype(np.float32)
    if jax_fn == "xla":
        ref_hm, ref_kn = JHM.synthesize_heatmaps(jnp.asarray(kps))
    else:
        ref_hm, ref_kn = synthesize_heatmaps_pallas(jnp.asarray(kps),
                                                    interpret=True)
    hm, kn = HM.synthesize_heatmaps(t32(kps))
    np.testing.assert_allclose(hm.numpy(), nchw(ref_hm), atol=1e-5)
    np.testing.assert_array_equal(kn.numpy(), np.asarray(ref_kn))


def test_kernel_wrapper_cpu_uses_plain_version():
    """A CPU tensor goes to the plain version (bit-identical, no launch)."""
    kps = t32(np.random.default_rng(1).uniform(-5, 70, (4, 5, 3)))
    before = HS.launches
    hm, kn = HS.synthesize_heatmaps(kps, inp_res=64, out_res=16)
    ref_hm, ref_kn = HM.synthesize_heatmaps(kps, inp_res=64, out_res=16)
    assert HS.launches == before
    assert torch.equal(hm, ref_hm) and torch.equal(kn, ref_kn)


@pytest.mark.parametrize("bad", ["float64", "shape", "device"])
def test_kernel_wrapper_rejects(bad):
    """The wrapper raises on what the kernel does not take, and on a device
    that is neither CPU nor CUDA — it never falls back."""
    kps = torch.zeros((2, 3, 3))
    if bad == "float64":
        kps = kps.double()
    elif bad == "shape":
        kps = torch.zeros((2, 3, 2))
    else:
        kps = kps.to("meta")
    with pytest.raises(ValueError):
        HS.synthesize_heatmaps(kps)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """The Triton kernel against its plain version on the card at the main
    path's shape: maps max abs <= 1e-6, kps_new exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Triton kernel has no CPU mode)")
    kps = torch.as_tensor(np.random.default_rng(0).uniform(
        -5, 260, (32, 9, 3)).astype(np.float32), device="cuda")
    before = HS.launches
    hm, kn = HS.synthesize_heatmaps(kps)
    ref_hm, ref_kn = HM.synthesize_heatmaps(kps)
    assert HS.launches == before + 1
    assert (hm - ref_hm).abs().max().item() <= 1e-6
    assert torch.equal(kn, ref_kn)


def test_decode(goldens):
    """Argmax decode exact; scores rtol 1e-6; image coords within 1 px and
    exact on > 98% (the JAX package's tolerances)."""
    g = goldens("decode")
    hm = t32(g["hm"])
    np.testing.assert_array_equal(HM.get_preds(hm).numpy(), g["preds_raw"])
    preds, scores = HM.decode_heatmaps(hm, t32(g["centers"]),
                                       t32(g["scales"]), res=(64, 64))
    np.testing.assert_allclose(scores.numpy(), g["scores"], rtol=1e-6)
    diff = np.abs(preds.numpy() - g["preds"])
    assert (diff <= 1).all()
    assert (diff == 0).mean() > 0.98


def test_get_preds_first_max_and_mask():
    """Ties resolve to the first maximum in row-major order; maps whose
    maximum is <= 0 decode to (0, 0)."""
    hm = torch.zeros((1, 3, 4, 4))
    hm[0, 0, 1, 2] = hm[0, 0, 3, 0] = 1.0      # tie: (row 1, col 2) first
    hm[0, 1] = -1.0                            # max <= 0 -> masked
    hm[0, 2, 2, 3] = 0.5
    got = HM.get_preds(hm)
    ref = JHM.get_preds(jnp.asarray(hm.permute(0, 2, 3, 1).numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got[0].numpy(), [[3, 2], [0, 0], [4, 3]])


def _decode_hm(goldens, signed):
    """decode.npz's maps; ``signed`` makes every third map all-negative, so
    the confidence mask of get_preds matters."""
    g = goldens("decode")
    hm = g["hm"].copy()
    if signed:
        hm[:, ::3] = -np.abs(hm[:, ::3]) - 0.1
    return hm, g["centers"], g["scales"]


@pytest.mark.parametrize("signed", [False, True])
def test_get_preds_all_matches_jax(goldens, signed):
    """Unmasked argmax decode == the JAX package's, exactly; on the
    all-negative maps it differs from get_preds, which gives (0, 0)."""
    hm, _, _ = _decode_hm(goldens, signed)
    got = HM.get_preds_all(t32(hm))
    ref = JHM.get_preds_all(jnp.asarray(np.moveaxis(hm, 1, -1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    masked = HM.get_preds(t32(hm))
    live = t32(hm).amax(dim=(-2, -1)) > 0
    assert torch.equal(masked[live], got[live])
    assert (masked[~live] == 0).all() and (got >= 1).all()
    assert bool((~live[:, ::3]).all()) == signed


@pytest.mark.parametrize("signed", [False, True])
def test_refine_quarter_pixel_matches_jax(goldens, signed):
    """Quarter-pixel refinement == the JAX package's, exactly (the shifts
    are +-0.25 and 0.5); peaks on the border are only moved by +0.5."""
    hm, _, _ = _decode_hm(goldens, signed)
    hm[0, 0] = 0.0
    hm[0, 0, 0, 5] = 1.0                         # a peak on the top border
    preds = HM.get_preds_all(t32(hm))
    got = HM.refine_quarter_pixel(t32(hm), preds)
    ref = JHM.refine_quarter_pixel(jnp.asarray(np.moveaxis(hm, 1, -1)),
                                   jnp.asarray(preds.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got[0, 0].numpy(), [6.5, 1.5])
    assert ((got - preds - 0.5).abs() == 0.25).any()


@pytest.mark.parametrize("n_models", [1, 3])
def test_decode_heatmaps_mul_matches_jax(goldens, n_models):
    """M models' maps decoded with their mean: coords and scores equal the
    JAX package's (coords atol 1e-4: one float32 affine; scores exact), and
    one model gives decode_heatmaps."""
    hm, centers, scales = _decode_hm(goldens, False)
    rng = np.random.default_rng(2)
    multi = np.stack([hm] + [np.roll(hm, int(s), axis=-1) * 0.9 for s in
                             rng.integers(1, 9, n_models - 1)])
    got = HM.decode_heatmaps_mul(t32(multi), t32(centers), t32(scales),
                                 (64, 64))
    ref = JHM.decode_heatmaps_mul(jnp.asarray(np.moveaxis(multi, 2, -1)),
                                  jnp.asarray(centers), jnp.asarray(scales),
                                  (64, 64))
    assert got[0].shape == (n_models, 8, 9, 2) and got[1].shape == (8, 9, 2)
    for a, b, atol in zip(got, ref, (1e-4, 1e-4, 0, 0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=1e-6)
    one = HM.decode_heatmaps(t32(hm), t32(centers), t32(scales), (64, 64))
    assert torch.equal(got[0][0], one[0]) and torch.equal(got[2][0], one[1])


def test_pck(goldens):
    """PCK with the -1 sentinels: errs rtol 1e-4 / atol 1e-5, accs
    rtol 1e-5 / atol 1e-6 (the JAX package's tolerances)."""
    g = goldens("pck")
    errs, accs = PCK.acc_pck(t32(g["preds"]), t32(g["gts"]), (1, 2), 0.2)
    np.testing.assert_allclose(errs.numpy(), g["errs"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(accs.numpy(), g["accs"], rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ augment

def _jax_draws(rng, B, flip_prob=0.5, noise_prob=0.5):
    """The draws of ubpl_tpu augment_batch, in its key-split order
    (augment.py:101, 52-55, 68-71)."""
    r_flip, r_noise, r_aff = jax.random.split(rng, 3)
    r_apply, r_con, r_bri = jax.random.split(r_noise, 3)
    r_s, r_a = jax.random.split(r_aff)
    return A.AugmentDraws(
        flip=torch.as_tensor(np.array(
            jax.random.uniform(r_flip, (B,)) <= flip_prob)),
        noise_apply=torch.as_tensor(np.array(
            jax.random.uniform(r_apply, (B,)) <= noise_prob)),
        contrast=t32(jax.random.uniform(r_con, (B,), minval=0.8, maxval=1.2)),
        brightness=t32(jax.random.uniform(r_bri, (B,), minval=-0.2,
                                          maxval=0.2)),
        scale_normal=t32(jax.random.normal(r_s, (B,))),
        angle_normal=t32(jax.random.normal(r_a, (B,))))


@pytest.mark.parametrize("use_flip", [True, False])
def test_augment_apply_matches_jax(use_flip):
    """The port's apply step fed JAX's draws reproduces JAX augment_batch:
    keypoints, centres, flips exact; scale/angle/warpmat at float32
    rounding (rtol 1e-6).  JAX warps with its two-pass TPU lowering, so the
    images are held to the same chain with JAX's exact gather sampler at
    the training path's source positions (flip -> noise -> gather) at
    atol 1e-5."""
    B, R, K = 4, 64, 5
    rng = np.random.default_rng(5)
    imgs = rng.uniform(0, 1, (B, R, R, 3)).astype(np.float32)
    kps = np.concatenate([rng.uniform(-3, R, (B, K, 2)),
                          np.ones((B, K, 1))], -1).astype(np.float32)
    kps[0, 0, 1] = 0.0                  # y <= 0: must not move
    center = np.full((B, 2), R // 2, np.float32)
    base_scale = np.full((B,), R / 200.0, np.float32)
    key = jax.random.PRNGKey(11)
    ref = JA.augment_batch(key, jnp.asarray(imgs), jnp.asarray(kps),
                           jnp.asarray(center), jnp.asarray(base_scale),
                           inp_res=R, use_flip=use_flip)
    got = A.augment_batch(t32(nchw(imgs)), t32(kps), t32(center),
                          t32(base_scale), _jax_draws(key, B), inp_res=R,
                          use_flip=use_flip)
    np.testing.assert_array_equal(got.kps.numpy(), np.asarray(ref.kps))
    np.testing.assert_array_equal(got.center.numpy(), np.asarray(ref.center))
    np.testing.assert_array_equal(got.isflip.numpy(), np.asarray(ref.isflip))
    for name in ("scale", "angle", "warpmat"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-6)
    # reference images: the same chain with the exact gather warp
    r_flip, r_noise, _ = jax.random.split(key, 3)
    x, c = jnp.asarray(imgs), jnp.asarray(center)
    if use_flip:
        x, _, c, _ = JA.random_flip(r_flip, x, jnp.asarray(kps), c)
    x = JA.noisy_mean(r_noise, x)
    mat = JT.affine_warp_matrix(c, ref.scale, ref.angle, (R, R))
    x = _gather_training_convention(x, mat, R)
    np.testing.assert_allclose(got.images.numpy(), nchw(x), atol=1e-5)


def test_draw_augment_ranges():
    """Draws come from the given generator, reproducibly, in their
    distributions' ranges."""
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return A.draw_augment(256, g, "cpu")
    d = draw(3)
    assert all(torch.equal(a, b) for a, b in zip(d, draw(3)))
    assert d.flip.dtype == torch.bool and 0 < d.flip.float().mean() < 1
    assert (d.contrast >= 0.8).all() and (d.contrast <= 1.2).all()
    assert (d.brightness >= -0.2).all() and (d.brightness <= 0.2).all()
    s, a = A.affine_params(torch.ones(256), d.scale_normal, d.angle_normal,
                           0.25, 30.0)
    assert (s >= 0.75).all() and (s <= 1.25).all()
    assert (a.abs() <= 30.0).all()


# ------------------------------------------------------------------- losses

@pytest.mark.parametrize("gated", [True, False])
def test_joint_mse(goldens, gated):
    """Reference JointMSELoss: sum rtol 1e-5, count exact."""
    g = goldens("losses")
    if gated:
        s, n = L.joint_mse(t32(g["preds"]), t32(g["gts"]), t32(g["gate"]),
                           t32(g["sw_pos"]), use_gate=True,
                           use_sample_weight=True)
        ref_s, ref_n = g["mse_sum"], g["mse_n"]
    else:
        s, n = L.joint_mse(t32(g["preds"]), t32(g["gts"]))
        ref_s, ref_n = g["mse_plain_sum"], g["mse_plain_n"]
    np.testing.assert_allclose(float(s), float(ref_s), rtol=1e-5)
    assert int(n) == int(ref_n)


def test_avg_counters_match_jax():
    """Host running means: same arithmetic as the JAX package's."""
    ours, ref = L.AvgCounters(), JL.AvgCounters()
    for i, (v, n) in enumerate([(0.5, 4), (0.25, 2), (1.0, 8)]):
        ours.update(i % 2, v, n)
        ref.update(i % 2, v, n)
    assert ours.avg() == ref.avg() and ours.sum() == ref.sum()
