"""Plain AdamW (Loshchilov & Hutter 2019, decoupled weight decay) and the
Mean Teacher EMA of the parameters, tensor by tensor."""
import math

import torch


class AdamW:
    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0):
        self.params = list(params)
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:          # off the loss's path: no update
                continue
            g = p.grad
            p.mul_(1 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = v.sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(m, denom, value=-self.lr / bc1)
            p.grad = None


@torch.no_grad()
def ema(teachers, students, alpha):
    for t, s in zip(teachers, students):
        for pt, ps in zip(t.parameters(), s.parameters()):
            pt.mul_(alpha).add_(ps, alpha=1.0 - alpha)
