"""Plain PyTorch reference of the MT_UBPL training step and of pose
serving.

The MT_UBPL step (Mean Teacher with UBPL's ensemble pseudo labels and
feature decorrelation; the reference project's projects/MT_UBPL.py): two
(student, EMA teacher) branches over two augmented views of one batch.

  PEC  pose_weight x heatmap MSE of every stack on the visible joints of
       the labelled rows, over S x (visible joints)
  MTC  cons_weight x MSE between each student's and its own teacher's
       last stacks, over B x K
  EPC  ensemble_pseudo_weight x MSE of every student stack against the
       mean of both teachers' last stacks, on the unlabelled rows, on the
       joints where both maxima reach pseudo_score_thr; over the count of
       non-zero weighted entries
  FDC  fdl_weight x the sum over views of the mean |covariance| between
       the two students' feature channels on the labelled rows, over the
       views' summed (rows x stacks x channels); counted twice in the loss
       (each branch's loss backs it into both)

Teachers run first, without gradient, in train-mode BatchNorm.  One AdamW
step over both students, then each teacher's parameters move to
``alpha * teacher + (1 - alpha) * student``.

Serving: the eval forward of uint8 BGR frames less the channel means, the
last stack's maps, and the argmax decode to image pixels
(``4 * (argmax - 1) + 1`` at 256 -> 64; coordinates of a map whose maximum
is not positive decode from 0).
"""
import torch

from . import augment as A


def sample_weights(islabeled, pseudo_weight):
    lab = (islabeled > 0).float()
    return lab, (1.0 - lab) * pseudo_weight


def stack_mse(a, b):
    return ((a - b) ** 2).mean(dim=(-2, -1))


def make_view(images_u8, kps, means, draws, inp_res, out_res, sf, rf):
    imgs, kps = A.augment(A.to_float(images_u8), kps, draws, inp_res, sf,
                          rf)
    imgs = A.normalize(imgs, means)
    hm, kps = A.heatmaps(kps, inp_res, out_res)
    return imgs, hm, kps


def forward(model, images, train=True):
    model.train(train)
    return model(images)


def mt_ubpl_loss(students, teachers, views, islabeled, sched, cfg):
    """The step's summed loss (a differentiable 0-dim tensor), the counts
    it divides by (``pec_count``, ``mtc_count``, ``epc_count`` per branch
    and ``fdc_count``) and its weighted terms (``pec``, ``mtc``, ``epc``
    per branch and ``fdc``, which the sum counts twice)."""
    sw_pos, sw_nega = sample_weights(islabeled, sched["pseudo_weight"])
    with torch.no_grad():
        t_out = [[forward(t, v[0])[0] for v in views] for t in teachers]
    s_fwd = [[forward(s, v[0]) for v in views] for s in students]
    M = len(students)
    total = 0.0
    counts = {"pec_count": [], "mtc_count": [], "epc_count": []}
    terms = {"pec": [], "mtc": [], "epc": []}
    thr = cfg["pseudo_score_thr"]
    for m in range(M):
        mtc = pec = epc = 0.0
        mtc_n = pec_n = epc_n = 0.0
        for a, (_, hm, kps) in enumerate(views):
            gate = kps[..., 2]
            p = s_fwd[m][a][0]                            # [B, S, K, H, W]
            S = p.shape[1]
            d = stack_mse(p[:, -1], t_out[m][a][:, -1])
            mtc, mtc_n = mtc + d.sum(), mtc_n + d.numel()
            e = stack_mse(p, hm[:, None]) * gate[:, None] * sw_pos[:, None,
                                                                    None]
            pec, pec_n = pec + e.sum(), pec_n + S * (gate > 0).sum()
            target = torch.stack([t_out[i][a][:, -1]
                                  for i in range(M)]).mean(0)
            loss = stack_mse(p, target[:, None]) * sw_nega[:, None, None]
            keep = ((p.amax(dim=(-2, -1)) >= thr)
                    & (target.amax(dim=(-2, -1))[:, None] >= thr))
            epc = epc + (loss * keep).sum()
            epc_n = epc_n + (loss > 0).sum()
        for k, w, s, n in (
                ("mtc", sched["cons_weight"], mtc, mtc_n),
                ("pec", cfg["pose_weight"], pec, pec_n),
                ("epc", cfg["ensemble_pseudo_weight"], epc, epc_n)):
            term = w * _ratio(s, n)
            total = total + term
            terms[k].append(float(term.detach()))
            counts[k + "_count"].append(float(n))
    fdc = fdc_n = 0.0
    for a in range(len(views)):
        fa, fb = s_fwd[0][a][1], s_fwd[1][a][1]           # [B, N, C, h, w]
        N, C = fa.shape[1:3]
        va, vb = fa.flatten(-2), fb.flatten(-2)
        cov = ((va - va.mean(-1, keepdim=True))
               * (vb - vb.mean(-1, keepdim=True))).sum(-1) / (
                   va.shape[-1] - 1)
        sel = (sw_pos > 0).float()
        n = sel.sum()
        fdc = fdc + (cov.abs() * sel[:, None, None]).sum() / (
            n.clamp(min=1) * N * C)
        fdc_n = fdc_n + n * N * C
    fdc = sched["fdl_weight"] * _ratio(fdc, fdc_n)
    total = total + 2.0 * fdc
    counts["fdc_count"] = [float(fdc_n)]
    terms["fdc"] = [float(fdc.detach())]
    return total, counts, terms


def _ratio(s, n):
    n = torch.as_tensor(n, dtype=torch.float32)
    return torch.where(n > 0, s / n.clamp(min=1), s)


def serve_maps(model, frames_u8, means):
    """Eval forward of [N, R, R, 3] uint8 frames: the last stack's maps
    [N, K, R/4, R/4]."""
    with torch.no_grad():
        preds, _ = forward(model, A.normalize(A.to_float(frames_u8), means),
                           train=False)
    return preds[:, -1]
