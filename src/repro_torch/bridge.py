"""Parameter bridge: the JAX package's params, as numpy arrays, into the port.

The reference keeps per-layer leaves stacked along a leading ``(L, ...)``
axis under ``params["layers"]`` (nested dicts included: the SSM family's
``{"ssm": {...}, "ln"}``); the port keeps a list of per-layer dicts.
Every other top-level entry (``embed``, the hybrid's unstacked
``shared`` block) crosses as it is. Every leaf keeps its layout (``wq``
``(d, H, Dh)``, ``wo`` ``(H, Dh, d)``, ``embed.out`` ``(d, Vp)``), so no
weight is transposed. This module imports neither JAX nor the JAX
package: callers hand it ``jax.tree.map(np.asarray, params)``.
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
