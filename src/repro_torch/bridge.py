"""Parameter bridge: the JAX package's params, optimizer state and batches,
as numpy arrays, into the port, and the port's trees back into the
reference's layout.

The reference keeps per-layer leaves stacked along a leading ``(L, ...)``
axis under each key of ``STACKED`` (``params["layers"]``, and the enc-dec
family's ``encoder`` and ``decoder``; nested dicts included: the SSM
family's ``{"ssm": {...}, "ln"}``, the decoder's ``{"self_attn",
"cross_attn", ...}``); the port keeps a list of per-layer dicts under
the same key. Every other top-level entry (``embed``, the hybrid's
unstacked ``shared`` block, the enc-dec ``enc_pos`` and ``enc_final``)
crosses as it is. Every leaf keeps its layout (``wq``
``(d, H, Dh)``, ``wo`` ``(H, Dh, d)``, ``embed.out`` ``(d, Vp)``), so no
weight is transposed. An ``AdamWState`` crosses field by field, its
moments in the params' layout (`opt_state_from_jax`,
`opt_state_to_reference`). `reference_leaves` names every leaf of a
port tree by the key the reference's checkpoint gives it
(``repro/checkpoint/ckpt.py``' ``_flatten_with_paths``: dict keys, a
NamedTuple's fields as ``.step``/``.mu``/``.nu``, list indices; the
per-layer lists of ``STACKED`` folded into one stacked key). This module
imports neither JAX nor the JAX package: callers hand it
``jax.tree.map(np.asarray, params)``, and get numpy back from
`to_reference`.
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


#: the top-level keys whose leaves the reference stacks over layers
STACKED = ("layers", "encoder", "decoder")


def from_jax(params_np: dict, *, device="cpu", dtype=None) -> dict:
    """``{key: {stacked (L, ...) leaves}, **rest}`` (numpy) ->
    ``{key: [per-layer dict] * L, **rest}`` (torch), for every ``key``
    of ``STACKED`` in the tree."""
    out = {}
    for k, v in params_np.items():
        if k not in STACKED:
            out[k] = _map(v, lambda a: _tensor(a, device, dtype))
            continue
        nl = len(_first_leaf(v))
        out[k] = [_map(v, lambda a, i=i: _tensor(np.asarray(a)[i], device,
                                                   dtype))
                  for i in range(nl)]
    return out


def to_reference(tree) -> dict:
    """``{key: [per-layer dict] * L, **rest}`` (torch: params or
    gradients) -> ``{key: {stacked (L, ...) leaves}, **rest}`` (fp32
    numpy), the reference's layout, for every ``key`` of ``STACKED``."""
    def host(t):
        return t.detach().float().cpu().numpy()

    def stack(*leaves):
        return np.stack([host(t) for t in leaves])

    def zip_map(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: zip_map([t[k] for t in trees]) for k in first}
        return stack(*trees)

    return {k: zip_map(list(v)) if k in STACKED else _map(v, host)
            for k, v in tree.items()}


def opt_state_from_jax(state_np, *, device="cpu"):
    """The reference's ``AdamWState(step, mu, nu)`` (numpy leaves, mu and
    nu in its stacked layout: the keys of ``STACKED``) -> the port's
    `AdamWState`."""
    from repro_torch.optim import AdamWState
    return AdamWState(
        step=torch.tensor(np.asarray(state_np.step), dtype=torch.int32,
                          device=device),
        mu=from_jax(state_np.mu, device=device),
        nu=from_jax(state_np.nu, device=device))


def opt_state_to_reference(state):
    """The port's `AdamWState` -> its fields in the reference's layout:
    ``step`` an int32 numpy scalar, ``mu`` and ``nu`` as `to_reference`
    lays out params (the inverse of `opt_state_from_jax`)."""
    from repro_torch.optim import AdamWState
    return AdamWState(
        step=np.asarray(state.step.detach().cpu().numpy(), np.int32),
        mu=to_reference(state.mu), nu=to_reference(state.nu))


def reference_leaves(tree, path=(), key=()):
    """``(path, key, layer, leaf)`` for every leaf of a port tree, in
    ``repro_torch.pytree``'s order: ``path`` the port's (dict keys, list
    and tuple indices, as ``sharding``'s walks give it), ``key`` the
    reference's "/"-joined checkpoint key and ``layer`` the leaf's index
    on the stacked axis of that key (None where the leaf crosses as it
    is): a list under a key of ``STACKED`` is the per-layer list the
    reference stacks, a NamedTuple's fields are named ``.<field>``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            v = tree[k]
            if k in STACKED and isinstance(v, list):
                for i, layer in enumerate(v):
                    for p, kk, _, leaf in reference_leaves(
                            layer, path + (k, i), key + (k,)):
                        yield p, kk, i, leaf
            else:
                yield from reference_leaves(v, path + (k,), key + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for i, (name, v) in enumerate(zip(tree._fields, tree)):
            yield from reference_leaves(v, path + (i,), key + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from reference_leaves(v, path + (i,), key + (str(i),))
    elif tree is not None:
        yield path, "/".join(key), None, tree


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
