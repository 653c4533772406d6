"""Parameter bridge: the JAX package's params, optimizer state and batches,
as numpy arrays, into the port, and the port's trees back into the
reference's layout.

The reference keeps per-layer leaves stacked along a leading ``(L, ...)``
axis under ``params["layers"]`` (nested dicts included: the SSM family's
``{"ssm": {...}, "ln"}``); the port keeps a list of per-layer dicts.
Every other top-level entry (``embed``, the hybrid's unstacked
``shared`` block) crosses as it is. Every leaf keeps its layout (``wq``
``(d, H, Dh)``, ``wo`` ``(H, Dh, d)``, ``embed.out`` ``(d, Vp)``), so no
weight is transposed. This module imports neither JAX nor the JAX
package: callers hand it ``jax.tree.map(np.asarray, params)``, and get
numpy back from `to_reference`.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: no numpy->torch path
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def from_jax(params_np: dict, *, device="cpu", dtype=None) -> dict:
    """``{"layers": {stacked (L, ...) leaves}, **rest}`` (numpy) ->
    ``{"layers": [per-layer dict] * L, **rest}`` (torch)."""
    stacked = params_np["layers"]
    nl = len(_first_leaf(stacked))
    out = {k: _map(v, lambda a: _tensor(a, device, dtype))
           for k, v in params_np.items() if k != "layers"}
    out["layers"] = [_map(stacked, lambda a, i=i: _tensor(np.asarray(a)[i],
                                                          device, dtype))
                     for i in range(nl)]
    return out


def to_reference(tree) -> dict:
    """``{"layers": [per-layer dict] * L, **rest}`` (torch: params or
    gradients) -> ``{"layers": {stacked (L, ...) leaves}, **rest}`` (fp32
    numpy), the reference's layout."""
    def host(t):
        return t.detach().float().cpu().numpy()

    def stack(*leaves):
        return np.stack([host(t) for t in leaves])

    def zip_map(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: zip_map([t[k] for t in trees]) for k in first}
        return stack(*trees)

    out = {k: _map(v, host) for k, v in tree.items() if k != "layers"}
    out["layers"] = zip_map(list(tree["layers"]))
    return out


def opt_state_from_jax(state_np, *, device="cpu"):
    """The reference's ``AdamWState(step, mu, nu)`` (numpy leaves, mu and
    nu in its stacked layout) -> the port's `AdamWState`."""
    from repro_torch.optim import AdamWState
    return AdamWState(
        step=torch.tensor(np.asarray(state_np.step), dtype=torch.int32,
                          device=device),
        mu=from_jax(state_np.mu, device=device),
        nu=from_jax(state_np.nu, device=device))


def batch_from_jax(batch_np: dict, *, device="cpu") -> dict:
    """A reference batch (numpy) as the port's tensors: ids int64, other
    entries as they are."""
    out = {}
    for k, a in batch_np.items():
        a = np.asarray(a)
        t = torch.from_numpy(np.array(a)).long() \
            if np.issubdtype(a.dtype, np.integer) else _tensor(a, device)
        out[k] = t.to(device)
    return out
