"""Uniform model API over the six architecture families (port of
``repro/models/registry.py``), and the training batches.

Every family serves and trains: dense, MoE (whose training takes expert
parallelism: ``ep_axis``, ``mesh``, ``a2a_algorithm``, a name or a
`Communicator`; every other family's takes tensor parallelism:
``tp_axis``, ``mesh``), SSM, hybrid, enc-dec (whisper: ``prefill`` takes
``audio=``) and VLM (llava: served through the dense family's token
``prefill``; ``vlm.prefill`` runs the ``[patches | tokens]`` batch)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, moe_model, ssm, transformer, vlm

_FAMILY = {"dense": transformer, "vlm": vlm, "moe": moe_model, "ssm": ssm,
           "hybrid": hybrid, "encdec": encdec}


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Any]             # generator -> params
    init_cache: Callable[..., dict]                    # (batch, cache_len) -> cache
    decode_step: Callable[..., tuple]                  # (params, cache, tokens)
    # (params, tokens, cache_len, **extra): extra carries per-family
    # inputs (encdec: audio=...)
    prefill: Callable[..., tuple]
    loss: Callable[..., tuple] = None                  # (params, batch)


def resolve_device(device) -> torch.device:
    """``cuda`` (the default everywhere) or ``cpu``; asking for cuda on a
    machine without a GPU raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def build_model(
    cfg: ModelConfig,
    *,
    window: int = 0,
    compute_dtype=torch.bfloat16,
    param_dtype=torch.float32,
    attn_impl: str = "auto",
    ssd_impl: str = "auto",
    device="cuda",
    remat: bool = False,
    ep_axis: str = None,
    tp_axis: str = None,
    mesh=None,
    a2a_algorithm="xla",
) -> ModelAPI:
    """The family's API. ``ep_axis`` (the MoE family's training only):
    expert parallelism over that axis of ``mesh``, the dispatch
    all-to-all through ``a2a_algorithm`` (a name or a `Communicator`);
    the params ``loss`` takes then hold this rank's experts
    (`sharding.ep_shard`). ``tp_axis`` (training of every other
    family): tensor parallelism over that axis of ``mesh``; the params
    ``loss`` takes then hold this rank's slices (`sharding.tp_shard`)."""
    if cfg.family not in _FAMILY:
        raise ValueError(f"unknown family {cfg.family!r}; one of "
                         f"{sorted(_FAMILY)}")
    dev = resolve_device(device)
    mod = _FAMILY[cfg.family]
    # the per-family keywords, as the reference passes them (encdec
    # takes no window)
    dkw: dict = {"compute_dtype": compute_dtype}
    if cfg.family in ("dense", "vlm", "moe", "hybrid"):
        dkw["window"] = window
    pkw = dict(dkw)
    if cfg.family in ("dense", "vlm", "moe", "hybrid", "encdec"):
        pkw["attn_impl"] = attn_impl
    if cfg.family in ("ssm", "hybrid"):
        pkw["ssd_impl"] = ssd_impl
    if ep_axis is not None and cfg.family != "moe":
        raise ValueError(f"expert parallelism needs the MoE family, not "
                         f"{cfg.family!r}")
    if tp_axis is not None and cfg.family == "moe":
        raise ValueError("the MoE family trains on a model axis through "
                         "expert parallelism (ep_axis)")
    lkw = dict(pkw)
    if cfg.family == "moe":
        lkw.update(ep_axis=ep_axis, mesh=mesh, a2a_algorithm=a2a_algorithm)
    elif tp_axis is not None:
        lkw.update(tp=mesh.axis(tp_axis))
    loss = functools.partial(mod.loss_fn, cfg=cfg, remat=remat, **lkw)
    # token-prompt prefill for serving; vlm decodes past the prefix as
    # pure text, so its serving prefill is the dense one (the batch-dict
    # [patches|tokens] prefill stays available as vlm.prefill)
    pmod = transformer if cfg.family == "vlm" else mod

    def prefill(params, tokens, cache_len, **extra):
        return pmod.prefill(params, tokens, cfg, cache_len, **pkw, **extra)

    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=functools.partial(mod.init_params, cfg=cfg, dtype=param_dtype,
                               device=dev),
        init_cache=functools.partial(mod.init_cache, cfg, device=dev),
        decode_step=functools.partial(mod.decode_step, cfg=cfg, **dkw),
        prefill=prefill,
        loss=loss,
    )


# ---------------------------------------------------------------------------
# batch construction
# ---------------------------------------------------------------------------
def train_batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Shapes/dtypes of a global training (or prefill) batch: tokens and
    labels, with the enc-dec family's ``audio`` frames and the VLM's
    ``patches`` in front of ``S - P`` text tokens."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return {
            "audio": ((B, cfg.encoder_seq, cfg.d_model), torch.bfloat16),
            "tokens": ((B, S), torch.int32),
            "labels": ((B, S), torch.int32),
        }
    if cfg.family == "vlm":
        P = cfg.num_patches
        if S <= P:
            raise ValueError(f"a VLM batch of {S} positions holds no text "
                             f"after its {P} patches")
        return {
            "patches": ((B, P, cfg.d_model), torch.bfloat16),
            "tokens": ((B, S - P), torch.int32),
            "labels": ((B, S), torch.int32),
        }
    return {
        "tokens": ((B, S), torch.int32),
        "labels": ((B, S), torch.int32),
    }


def make_train_batch(cfg: ModelConfig, shape: ShapeConfig,
                     seed: int = 0) -> dict:
    """A random global batch from numpy's generator seeded with ``seed``
    (the reference's draws, in its order), as numpy arrays: ids int32,
    the VLM's labels -1 over the patch positions, frames and patches
    standard normal in float32."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shp, dt) in train_batch_shapes(cfg, shape).items():
        if dt == torch.int32:
            arr = rng.integers(0, cfg.vocab_size, size=shp, dtype=np.int32)
            if name == "labels" and cfg.family == "vlm":
                arr[:, :cfg.num_patches] = -1      # ignore image positions
        else:
            arr = rng.normal(size=shp).astype(np.float32)
        out[name] = arr
    return out
