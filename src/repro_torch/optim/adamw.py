"""AdamW with decoupled weight decay and global-norm clipping, port of
``repro/optim/adamw.py``: over the port's parameter trees (dicts and
lists of tensors, ``repro_torch.pytree``), updated in place, with the
reference's operations in its order."""
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
               lr_scale=1.0, gnorm=None):
        """One step, written into ``params`` and ``state``'s moments leaf
        by leaf (as the reference's step donates its buffers to XLA: the
        caller reads the old values no more); returns them with the new
        step count. ``gnorm``: the clip's global norm, where ``grads`` is
        a slice of the tree it is taken over (an expert-parallel rank's);
        default ``global_norm(grads)``."""
        step = state.step + 1
        scale = None
        if self.grad_clip > 0:
            if gnorm is None:
                gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)

        b1, b2 = self.beta1, self.beta2
        t = step.to(torch.float32)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        lr = self.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                       device=t.device)
        for p, m, v, g in zip(pytree.leaves(params),
                              pytree.leaves(state.mu),
                              pytree.leaves(state.nu),
                              pytree.leaves(grads)):
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            mh = m / bc1
            vh = v / bc2
            p.sub_(lr * (mh / (torch.sqrt(vh) + self.eps)
                         + self.weight_decay * p))
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the fp32 sum of squares of every leaf, leaves summed in
    tree order."""
    total = None
    for x in pytree.leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)
