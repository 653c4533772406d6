"""AdamW with decoupled weight decay and global-norm clipping, port of
``repro/optim/adamw.py``: over the port's parameter trees (dicts and
lists of tensors, ``repro_torch.pytree``), tensors in, new tensors out,
with the reference's operations in its order."""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import pytree


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        first = pytree.leaves(params)[0]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=pytree.tree_map(torch.zeros_like, params),
            nu=pytree.tree_map(torch.zeros_like, params),
        )

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, *,
               lr_scale=1.0):
        step = state.step + 1
        if self.grad_clip > 0:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
            grads = pytree.tree_map(lambda g: g * scale, grads)

        b1, b2 = self.beta1, self.beta2
        mu = pytree.tree_map(lambda m, g: b1 * m + (1 - b1) * g,
                             state.mu, grads)
        nu = pytree.tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                             state.nu, grads)
        t = step.to(torch.float32)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        lr = self.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                       device=t.device)

        def upd(p, m, v):
            mh = m / bc1
            vh = v / bc2
            return (p - lr * (mh / (torch.sqrt(vh) + self.eps)
                              + self.weight_decay * p)).to(p.dtype)

        new_params = pytree.tree_map(upd, params, mu, nu)
        return new_params, AdamWState(step=step, mu=mu, nu=nu)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the fp32 sum of squares of every leaf, leaves summed in
    tree order."""
    total = None
    for x in pytree.leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)
