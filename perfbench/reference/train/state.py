"""Train state and optimizer, matching `dcf.train.state`: global-norm
gradient clipping, then AdamW on a linear-warmup + cosine-decay schedule,
written out so that each rule is optax's:

  - the learning rate is optax's `warmup_cosine_decay_schedule(lr * 0.01,
    lr, warmup, max(num_steps, warmup + 1), lr * 0.01)`, evaluated at the
    update count before it is incremented;
  - clipping scales the grads by max_norm / norm only when the norm
    exceeds max_norm (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the
    norm: another rule);
  - AdamW: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
    correction at the incremented count, and weight decay on every
    parameter (optax `mask=None`).

The updates run in place on the parameters (`torch._foreach_*`), where
optax returns new arrays.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch import nn

from perfbench.reference.config import Config, TrainConfig


def lr_schedule(t: TrainConfig) -> Callable[[int], float]:
    """The learning rate at update count `count` (0 for the first)."""
    init = end = t.learning_rate * 0.01
    peak = t.learning_rate
    warmup = t.warmup_steps
    decay = max(t.num_steps, t.warmup_steps + 1) - warmup
    alpha = end / peak if peak else 0.0

    def schedule(count: int) -> float:
        if count < warmup:
            frac = 1.0 - count / warmup
            return (init - peak) * frac + peak
        c = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (a device scalar: no
    host sync)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class AdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule,
    weight_decay)) over a list of parameters, updated in place."""

    def __init__(self, params: List[torch.Tensor],
                 schedule: Callable[[int], float], weight_decay: float,
                 max_norm: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """One update from `grads` (one per parameter, unclipped)."""
        norm = global_norm(grads)
        scale = torch.where(norm > self.max_norm,
                            self.max_norm / norm, torch.ones_like(norm))
        g = torch._foreach_mul(grads, scale)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - self.b2)
        lr = self.schedule(self.count)
        self.count += 1
        mu_hat = torch._foreach_div(self.mu, 1.0 - self.b1 ** self.count)
        denom = torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_add_(mu_hat, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, mu_hat, alpha=-lr)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        self.count = int(sd["count"])
        torch._foreach_copy_(self.mu, list(sd["mu"]))
        torch._foreach_copy_(self.nu, list(sd["nu"]))


def make_optimizer(cfg: Config, model: nn.Module) -> AdamW:
    t = cfg.train
    return AdamW(list(model.parameters()), lr_schedule(t), t.weight_decay,
                 t.grad_clip_norm)
