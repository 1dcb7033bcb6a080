"""Plain PyTorch reference of the semi-supervised classification step in
its mt_ubpl mode (Mean Teacher, Tarvainen & Valpola 2017, with UBPL's
ensemble pseudo labels and feature distance): two (student, EMA teacher)
pairs on one augmented view of the batch.

  CE      cross-entropy of head 1 on the labelled rows, mean per student
  cons    cons_weight x sum over rows of |softmax(student) -
          softmax(own teacher)|^2 / classes, over the batch size
  pseudo  cons_weight x MSE of the student's softmax against the mean of
          both teachers' softmaxes, weighted by the unlabelled rows'
          pseudo weight, over the weighted rows
  fdl     sum over rows of 1 / mean squared distance between the two
          students' stage-3 taps, over the batch size; counted twice

The view is the pose view's flip -> noise -> warp chain with the image's
centre and a 32-pixel frame, then the channel means subtracted.
"""
import torch

from . import augment as A


def make_view(images_u8, means, draws, inp_res, sf, rf):
    B = images_u8.shape[0]
    dummy = torch.zeros(B, 1, 3, device=images_u8.device)
    imgs, _ = A.augment(A.to_float(images_u8), dummy, draws, inp_res, sf,
                        rf)
    return A.normalize(imgs, means)


def class_loss(students, teachers, view, labels, islabeled, sched):
    """The step's summed loss (a differentiable 0-dim tensor) and its
    terms: ``ce``, ``cons`` and ``pseudo`` as means over the students,
    and ``fdl``, which the sum counts twice."""
    pw, cw = sched["pseudo_weight"], sched["cons_weight"]
    sw = (1.0 - (islabeled > 0).float()) * pw
    with torch.no_grad():
        t_logits = torch.stack([_fwd(t, view)[0] for t in teachers])
    outs = [_fwd(s, view) for s in students]
    t_soft = torch.softmax(t_logits, -1)
    valid = labels >= 0
    n_valid = valid.sum()
    total = 0.0
    terms = {"ce": 0.0, "cons": 0.0, "pseudo": 0.0}
    for m, (logits, _) in enumerate(outs):
        logp = torch.log_softmax(logits, -1)
        nll = -(logp.gather(-1, torch.where(valid, labels, 0)[:, None])[:, 0]
                * valid.float()).sum()
        soft = torch.softmax(logits, -1)
        bs, c = logits.shape
        pseudo = (((soft - t_soft.mean(0)) ** 2).mean(-1) * sw).sum()
        n_w = (sw > 0).sum()
        for k, term in (
                ("ce", torch.where(n_valid > 0, nll / n_valid.clamp(min=1),
                                   nll)),
                ("cons", cw * ((soft - t_soft[m]) ** 2).sum() / c / bs),
                ("pseudo", cw * torch.where(n_w > 0,
                                            pseudo / n_w.clamp(min=1),
                                            pseudo))):
            total = total + term
            terms[k] += float(term.detach()) / len(outs)
    f1, f2 = outs[0][1], outs[1][1]
    bs, c = f1.shape[:2]
    d = ((f1.reshape(bs, c, -1) - f2.reshape(bs, c, -1)) ** 2)
    fdl = (1.0 / d.mean(-1).mean(-1)).sum() / bs
    terms = {k: [v] for k, v in terms.items()}
    terms["fdl"] = [float(fdl.detach())]
    return total + 2.0 * fdl, terms


def _fwd(model, x):
    model.train(True)
    (logits, _), feat = model(x)
    return logits, feat
