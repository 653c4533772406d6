"""The hybrid and VLM families' sharded training steps: the compile-free
trace against the real step.

``chip_smoke.py`` holds zamba2-2.7b's full-depth step under FSDP on
``("data", "model")`` = 4 x 1 and llava-next-mistral-7b's under FSDP +
tensor parallelism on 2 x 2 to the `meta` trace of the same step
(`dryrun.trace_step` over `group.MetaMesh`): params a rank, step 0's
collectives and the kernels' launches equal. These are the equalities
it relies on, at the reduced configs: one spawned group of four ``gloo``
ranks on the CPU runs both steps, each rank under a `StepCounter`, and
every rank's account is held to the trace at its coordinate, rank for
rank: params a rank, the collectives by kind, axis, count and bytes in
issue order, FLOPs, and the launches of the SSD chunk and flash kernels.
Both run with bf16 gathers (``gather_in_compute_dtype``), as on the
card. The hybrid's shared block is gathered once a step with the rest of
the tree (not once an application): one all-gather a mamba layer and
one more. The VLM keeps two kv heads (``reduced()`` leaves one), so its
kv heads are split over ``model`` as llava's 8 are on the card.

The tests of this module run with one intra-op thread
(`one_intra_op_thread`), as ``tests/test_torch_train.py``'s do.
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
from repro_torch.launch import accounting as acct  # noqa: E402
from repro_torch.launch import steps  # noqa: E402

PARALLEL = ParallelConfig(shard_params_over_data=True,
                          gather_in_compute_dtype=True)
#: arch -> (config, shape, mesh): zamba2 under FSDP alone over four data
#: ranks, llava under FSDP + tensor parallelism over 2 x 2
CASES = {
    "zamba2-2.7b": (ARCHITECTURES["zamba2-2.7b"].reduced(),
                    ShapeConfig("hybrid", 64, 4, "train"),
                    ((4, 1), ("data", "model"))),
    "llava-next-mistral-7b": (
        ARCHITECTURES["llava-next-mistral-7b"].reduced().replace(
            num_kv_heads=2),
        ShapeConfig("vlm", 48, 2, "train"), ((2, 2), ("data", "model"))),
}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Every test of this module with one intra-op thread, restored after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _account(arch, mesh, device, gen):
    """One rank's step under a `StepCounter`: its params a rank, its
    collectives, FLOPs and kernel launches."""
    cfg, shape, _ = CASES[arch]
    step = steps.build_train_step(cfg, shape, PARALLEL, CollectiveConfig(),
                                  mesh, device=device)
    counter, _ = acct.trace(step.fn, *step.example_args(gen), device=device)
    return {"params": counter.params, "collectives": counter.record.entries,
            "flops": counter.flops, "kernels": dict(counter.kernels)}


def _rank_accounts():
    torch.set_num_threads(1)
    meshes = {arch: grp.RankMesh(*mesh) for arch, (_, _, mesh)
              in CASES.items()}
    out = {arch: _account(arch, meshes[arch], "cpu",
                          torch.Generator().manual_seed(0))
           for arch in CASES}
    box = [None] * grp.size()
    torch.distributed.all_gather_object(box, out)
    return box


@pytest.fixture(scope="module")
def real_runs():
    return grp.spawn(_rank_accounts, 4, timeout_s=300)


def _want_kernels(arch):
    """Launches of one rank-step: an SSD chunk forward and backward a
    mamba layer, a flash forward and backward (two launches) a shared
    application or attention layer."""
    cfg = CASES[arch][0]
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // cfg.attn_every
        return {"ssd_chunk": cfg.num_layers, "ssd_chunk_bwd": cfg.num_layers,
                "flash_attention": n_attn, "flash_attention_bwd": 2 * n_attn}
    return {"flash_attention": cfg.num_layers,
            "flash_attention_bwd": 2 * cfg.num_layers}


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("arch", sorted(CASES))
def test_meta_trace_equals_the_real_step(real_runs, arch, rank):
    _, _, (shape, names) = CASES[arch]
    got = _account(arch, grp.MetaMesh(shape, names,
                                      np.unravel_index(rank, shape)),
                   "meta", None)
    want = real_runs[rank][arch]
    assert got["params"] == want["params"]
    assert got["collectives"] == want["collectives"]
    assert got["flops"] == want["flops"] > 0
    assert got["kernels"] == want["kernels"] == _want_kernels(arch)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_one_gather_a_layer_and_one_for_the_rest(real_runs, arch):
    """The gather points: one all-gather and one reduce-scatter over
    ``data`` a layer and one for the rest of the tree (the hybrid's
    shared block with it, once a step); llava's blocks all-reduce over
    ``model``."""
    cfg = CASES[arch][0]
    for rank in range(4):
        kinds = [(k, axis) for k, axis, _ in
                 real_runs[rank][arch]["collectives"]]
        for kind in ("all-gather", "reduce-scatter"):
            assert kinds.count((kind, "data")) == cfg.num_layers + 1
        assert (("all-reduce", "model") in kinds) == \
            (cfg.family == "vlm")


def test_params_a_rank_follow_the_layouts(real_runs):
    """zamba2 over four data ranks holds a quarter of each weight FSDP
    splits; llava's ranks of one model coordinate hold equal counts."""
    z = [real_runs[r]["zamba2-2.7b"]["params"] for r in range(4)]
    v = [real_runs[r]["llava-next-mistral-7b"]["params"] for r in range(4)]
    assert len(set(z)) == 1 and len(set(v)) == 1
    whole = {arch: sum(t.numel() for t in _leaves(arch)) for arch in CASES}
    assert z[0] < whole["zamba2-2.7b"] / 2
    assert v[0] < whole["llava-next-mistral-7b"] / 2


def _leaves(arch):
    from repro_torch import pytree
    from repro_torch.models.registry import build_model
    return pytree.leaves(build_model(CASES[arch][0],
                                     device="meta").init_meta())
