"""Checkpointing (port of ``repro/checkpoint/ckpt.py``): a tree of
tensors (params, optimizer state) round-trips through the reference's
format, an ``arrays.npz`` bundle beside a JSON ``manifest.json`` keyed
by the leaves' paths ("/"-joined dict keys and list indices, in
``repro_torch.pytree``'s order). The port's trees keep a list of
per-layer dicts where the reference stacks the layers, so the keys
differ from the reference's for the same model; restoring across the
two packages is ROADMAP.md Queue 1 step 10.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import pytree


def _paths(tree, prefix=()):
    """The leaves' paths, in ``pytree.leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:        # numpy has no bfloat16
        t = t.float()
    return t.numpy()


def save(path: str, tree: Any, *, step: int = 0,
         extra: Optional[dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for key, leaf in zip(_paths(tree), pytree.leaves(tree)):
        arr = _to_numpy(torch.as_tensor(leaf))
        arrays[key.replace("/", "__")] = arr
        manifest["leaves"].append({"key": key, "dtype": str(leaf.dtype)
                                   .rsplit(".", 1)[-1],
                                   "shape": list(arr.shape)})
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def restore(path: str, like: Any, *, device=None):
    """Restore into the structure, dtypes and (unless ``device`` is
    given) devices of ``like``; returns (tree, step, extra)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    by_key = {r["key"]: data[r["key"].replace("/", "__")]
              for r in manifest["leaves"]}
    flat, treedef = pytree.flatten(like)
    out = []
    for key, leaf in zip(_paths(like), flat):
        arr = by_key[key]
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs "
                             f"{tuple(leaf.shape)}")
        out.append(torch.from_numpy(np.array(arr)).to(
            device=device if device is not None else leaf.device,
            dtype=leaf.dtype))
    return treedef.unflatten(out), manifest["step"], manifest["extra"]
