"""The prefill and decode steps of ``launch/steps.py`` on a ``model`` axis
against the one-process model.

Four spawned ``gloo`` ranks on the CPU, ``("data", "model")`` = 2 x 2,
fp32 compute, reduced configs of every family: each rank holds its
`sharding.shard` of the same seeded draw and its `sharding.cache_shard`
block of a cache primed by a one-process prefill, and its decode step
(tensor-parallel, or expert-parallel for the MoE family) gives the
logits and the greedy tokens of the one-process decode of its rows,
with the cache's slots whole and split over ``model``
(``shard_cache_seq``). The layouts covered: kv heads split (olmoe,
zamba2's shared block, whisper's self and cross KV), the mixed layout
(query heads split, one kv head: smollm, glm4, llava), SSD states split
by heads (mamba2, zamba2), and the slots split (every attention cache,
whisper's frames too). The prefill step's last logits are the
one-process prefill's, this rank's vocab block. The MoE prefill routes
each rank's sequence chunk as its own group, as training does, so the
MoE config here has a capacity no expert can exceed (no token dropped,
so the grouping changes no value).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHITECTURES  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    CollectiveConfig,
    ParallelConfig,
    ShapeConfig,
)
from repro_torch.core.collectives import group as grp  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import vlm  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

ARCHS = ("smollm-135m", "glm4-9b", "olmoe-1b-7b", "mamba2-130m",
         "zamba2-2.7b", "whisper-large-v3", "llava-next-mistral-7b")
PROMPT, CACHE, B = 32, 64, 4
FP32 = ParallelConfig(compute_dtype="float32")
TOL = 1e-4           # max |got - want| / max |want|, fp32


def _inputs(cfg):
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT)))
    token = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
    extra = {}
    if cfg.family == "encdec":
        extra["audio"] = torch.from_numpy(rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return prompt, token.to(torch.int32), extra


def _rows(tree, rows):
    """A whole cache's rows (its batch on axis 1; ``length`` shared)."""
    return {k: _rows(v, rows) if isinstance(v, dict)
            else (v if v.dim() == 0 else v[:, rows].clone())
            for k, v in tree.items()}


def _check(arch, mesh, seq):
    cfg = ARCHITECTURES[arch].reduced()
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=float(cfg.num_experts))
    shape = ShapeConfig("serve", CACHE, B, "decode")
    step = steps.build_decode_step(cfg, shape, FP32, CollectiveConfig(),
                                   mesh, shard_cache_seq=seq, device="cpu")
    api = step.api
    full = api.init(torch.Generator().manual_seed(0))
    prompt, token, extra = _inputs(cfg)
    _, cache = api.prefill(full, prompt, CACHE, **extra)
    rows = step.rows
    want, _ = api.decode_step(full, _rows(cache, rows), token[rows])
    held = step.init(torch.Generator().manual_seed(0))
    block = sh.cache_shard(cache, mesh, cfg, shard_cache_seq=seq)
    got, _ = api.decode_step(held, block, token[rows], **step.decode_kw)
    block = sh.cache_shard(cache, mesh, cfg, shard_cache_seq=seq)
    nxt, _ = step.fn(held, block, token[rows])
    out = {"logits": (got - want).abs().max().item() /
           want.abs().max().item(),
           "tokens": torch.equal(nxt[:, 0], torch.argmax(want, -1).to(
               torch.int32)),
           "kw": sorted(step.decode_kw)}
    if not seq:
        pre = steps.build_prefill_step(cfg, ShapeConfig("p", PROMPT, B,
                                                        "prefill"),
                                       FP32, CollectiveConfig(), mesh,
                                       device="cpu")
        batch = {"tokens": prompt[rows], **{k: v[rows] for k, v in
                                             extra.items()}}
        if cfg.family == "vlm":
            patches = torch.from_numpy(np.random.default_rng(4).normal(
                size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32))
            batch = {"patches": patches[rows], "tokens": prompt[rows]}
            whole, _ = vlm.prefill(full, batch, cfg, PROMPT + cfg.num_patches,
                                   compute_dtype=torch.float32)
        else:
            whole, _ = api.prefill(full, prompt[rows], CACHE, **{
                k: v[rows] for k, v in extra.items()})
        last = pre.fn(held, batch)
        lo = grp.rank(mesh.axis("model")) * last.shape[-1] \
            if last.shape[-1] != whole.shape[-1] else 0
        ref = whole[:, -1, lo:lo + last.shape[-1]]
        out["prefill"] = (last - ref).abs().max().item() / \
            ref.abs().max().item()
    return out


def _rank_checks():
    mesh = grp.RankMesh((2, 2), ("data", "model"))
    res = {(arch, seq): _check(arch, mesh, seq)
           for arch in ARCHS for seq in (False, True)}
    box = [None] * grp.size()
    torch.distributed.all_gather_object(box, res)
    return box


@pytest.fixture(scope="module")
def runs():
    return grp.spawn(_rank_checks, 4, timeout_s=300)


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_the_model_axis_is_the_one_process_decode(runs, arch, seq):
    for rank in range(4):
        r = runs[rank][(arch, seq)]
        assert r["logits"] < TOL, (rank, r)
        assert r["tokens"], (rank, r)
        cfg = ARCHITECTURES[arch]
        axes = {"moe": ["ep_axis", "mesh"]}.get(cfg.family, ["tp"])
        if seq and cfg.family != "ssm":
            axes += ["seq_axis"] + (["cross_seq_axis"]
                                    if cfg.family == "encdec" else [])
        assert r["kw"] == sorted(axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_the_model_axis_is_the_one_process_prefill(runs, arch):
    for rank in range(4):
        assert runs[rank][(arch, False)]["prefill"] < TOL
