"""The port's compile-free step accounting against the JAX package.

* ``param_count`` and ``model_flops`` equal ``repro.launch.hlo_analysis``'s
  for every architecture x shape.
* Each hand-written kernel's count on ``meta`` (``repro_torch.count``)
  equals what ``torch.utils.flop_counter.FlopCounterMode`` counts for its
  plain reference at the same shapes, forward and backward: causal,
  windowed, GQA, fp32 and bf16.
* The meta trace of a step over a recording mesh (``group.MetaMesh``)
  equals a real run of the same step: four spawned ``gloo`` ranks on the
  CPU, ``("data", "model")`` = 2 x 2, FSDP + tensor parallelism
  (smollm-135m reduced) and FSDP + expert parallelism (olmoe-1b-7b
  reduced), each rank under a `StepCounter` on the host. Equal, rank for
  rank: params a rank, the collectives by kind, axis, count and bytes in
  issue order, FLOPs and kernel launches. A planted fault (a meta
  reduce-scatter recording its input's bytes) is caught.
* ``cache_specs`` equals the reference's for every family's decode
  cache on 2 x 2 and 16 x 16, with and without ``shard_cache_seq``, and
  ``serve_plan`` for every architecture x shape.
* Params a rank of the training step on the 16 x 16 production mesh
  equal the element counts the reference's ``param_specs`` gives its
  ``jax.eval_shape`` params, for every family but MoE, and for MoE's
  expert stacks (under expert parallelism the port splits only the
  experts).
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import ARCHITECTURES as JARCH  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.launch import hlo_analysis as jha  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch import count, pytree  # noqa: E402
from repro_torch.configs import ARCHITECTURES, SHAPES  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    CollectiveConfig,
    ParallelConfig,
    ShapeConfig,
)
from repro_torch.core.collectives import group as grp  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    attention,
    ref,
    segment_reduce,
    ssd_scan,
)
from repro_torch.launch import accounting as acct  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

ARCHS = sorted(ARCHITECTURES)


# ---------------------------------------------------------------------------
# (a) the analytic counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = ARCHITECTURES[arch], JARCH[arch]
    for active in (False, True):
        assert acct.param_count(cfg, active_only=active) == \
            jha.param_count(jcfg, active_only=active)
    for name in SHAPES:
        assert acct.model_flops(cfg, SHAPES[name]) == \
            jha.model_flops(jcfg, JSHAPES[name])


# ---------------------------------------------------------------------------
# (b) the kernels' counts on meta
# ---------------------------------------------------------------------------
class _Notes:
    """A counter that keeps the kernels' notes."""

    paused = 0

    def __init__(self):
        self.notes = []

    def kernel(self, name, flops, nbytes, launches):
        self.notes.append((name, flops, launches))


@pytest.fixture
def notes():
    n = _Notes()
    count._OPEN.append(n)
    yield n.notes
    count._OPEN.remove(n)


def _flops(fn, *args):
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    return fc.get_total_flops(), out


def _meta(*ts):
    return [t.detach().to("meta").requires_grad_(t.requires_grad)
            for t in ts]


ATTN_CASES = [(2, 64, 64, 4, 2, 64, True, 0), (1, 48, 48, 4, 4, 64, True, 16),
              (2, 32, 32, 6, 2, 80, False, 0), (1, 16, 40, 2, 1, 128, True, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_meta_flops_equal_the_plain_reference(notes, case, dtype):
    B, S, T, H, KV, D, causal, window = case
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shp, generator=g, dtype=dt).requires_grad_()
               for shp in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))
    q_off = T - S
    fwd, o = _flops(lambda: ref.attention(q, k, v, causal=causal,
                                          window=window, q_offset=q_off))
    bwd, _ = _flops(lambda: torch.autograd.grad(o.float().sum(), [q, k, v]))
    qm, km, vm = _meta(q, k, v)
    before = attention.launches
    om = attention.flash_attention(qm, km, vm, causal=causal, window=window,
                                   q_offset=q_off)
    grads = torch.autograd.grad(om.float().sum(), [qm, km, vm])
    assert attention.launches == before          # nothing ran
    assert om.shape == q.shape and om.dtype == dt and om.device.type == "meta"
    assert [x.shape for x in grads] == [q.shape, k.shape, v.shape]
    assert notes == [("flash_attention", fwd, 1),
                     ("flash_attention_bwd", bwd, 2)]


SSD_CASES = [(2, 64, 4, 32, 16, 16), (1, 128, 3, 64, 8, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_meta_flops_equal_the_plain_version(notes, case, dtype):
    Bz, S, H, P, N, Q = case
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(Bz, S, H, P, generator=g, dtype=dt).requires_grad_()
    dtt = torch.rand(Bz, S, H, generator=g).requires_grad_()
    A = (-torch.rand(H, generator=g)).requires_grad_()
    Bm, Cm = (torch.randn(Bz, S, N, generator=g, dtype=dt).requires_grad_()
              for _ in range(2))
    fwd, y = _flops(lambda: ssd_scan.ssd_chunked_plain(x, dtt, A, Bm, Cm,
                                                       chunk=Q))
    bwd, _ = _flops(lambda: torch.autograd.grad(
        sum(t.sum() for t in y), [x, dtt, A, Bm, Cm]))
    ms = _meta(x, dtt, A, Bm, Cm)
    ym = ssd_scan.SSDChunk.apply(*ms, Q)
    assert [t.shape for t in ym] == [t.shape for t in y]
    torch.autograd.grad(sum(t.sum() for t in ym), ms)
    launches = 1 if dt == torch.bfloat16 else 2
    assert notes == [("ssd_chunk", fwd, 1), ("ssd_chunk_bwd", bwd, launches)]


def test_combine_meta_counts_no_flops_as_the_plain_version(notes):
    a = torch.ones(64)
    fwd, _ = _flops(lambda: segment_reduce.segment_combine_plain(a, a, "add"))
    m = torch.empty(64, device="meta")
    out = segment_reduce.segment_combine(m, torch.empty_like(m), out=m)
    assert out is m and fwd == 0
    assert notes == [("segment_combine", 0, 1)]


# ---------------------------------------------------------------------------
# (c) the meta trace against a real run of the same step
# ---------------------------------------------------------------------------
SHAPE = ShapeConfig("acct", 64, 8, "train")
PARALLEL = ParallelConfig(shard_params_over_data=True)
MESH = ((2, 2), ("data", "model"))
STEP_ARCHS = ("smollm-135m", "olmoe-1b-7b")


def _account(arch, mesh, device, gen):
    """One rank's step under a `StepCounter`: its params a rank, its
    collectives, FLOPs and kernel launches."""
    cfg = ARCHITECTURES[arch].reduced()
    step = steps.build_train_step(cfg, SHAPE, PARALLEL, CollectiveConfig(),
                                  mesh, device=device)
    counter, _ = acct.trace(step.fn, *step.example_args(gen), device=device)
    return {"params": counter.params, "collectives": counter.record.entries,
            "flops": counter.flops, "kernels": dict(counter.kernels)}


def _rank_accounts():
    mesh = grp.RankMesh(*MESH)
    out = {arch: _account(arch, mesh, "cpu",
                          torch.Generator().manual_seed(0))
           for arch in STEP_ARCHS}
    box = [None] * grp.size()
    torch.distributed.all_gather_object(box, out)
    return box


@pytest.fixture(scope="module")
def real_runs():
    return grp.spawn(_rank_accounts, 4, timeout_s=300)


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_meta_trace_equals_the_real_step(real_runs, arch, rank):
    coords = np.unravel_index(rank, MESH[0])
    got = _account(arch, grp.MetaMesh(*MESH, coords), "meta", None)
    want = real_runs[rank][arch]
    assert got["params"] == want["params"]
    assert got["collectives"] == want["collectives"]
    assert got["flops"] == want["flops"] > 0
    assert got["kernels"] == want["kernels"] == {
        "flash_attention": 2, "flash_attention_bwd": 4}
    kinds = {k for k, _, _ in got["collectives"]}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds


def test_a_planted_recording_fault_is_caught(real_runs):
    with grp.planted_record_fault():
        got = _account("smollm-135m", grp.MetaMesh(*MESH), "meta", None)
    want = real_runs[0]["smollm-135m"]
    assert got["flops"] == want["flops"]
    assert got["collectives"] != want["collectives"]
    bad = [(g, w) for g, w in zip(got["collectives"], want["collectives"])
           if g != w]
    assert bad and all(g[0] == "reduce-scatter" and g[2] == 2 * w[2]
                       for g, w in bad)


# ---------------------------------------------------------------------------
# (d) cache_specs, (e) serve_plan
# ---------------------------------------------------------------------------
FAMILY_ARCHS = ("smollm-135m", "glm4-9b", "olmoe-1b-7b", "mamba2-130m",
                "zamba2-2.7b", "whisper-large-v3", "llava-next-mistral-7b")
MESHES = {"2x2": {"data": 2, "model": 2}, "16x16": {"data": 16, "model": 16}}


def _fake_mesh(shape):
    return types.SimpleNamespace(shape=dict(shape),
                                 axis_names=tuple(shape))


def _entry(e):
    """A spec entry as ``PartitionSpec`` keeps it (one axis, not a
    one-tuple)."""
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _by_path(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))
    return {jsh._path_str(p): tuple(_entry(e) for e in v) for p, v in flat}


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cache_specs_equal_the_reference(arch, mesh, seq):
    shape = SHAPES["decode_32k"]
    plan = steps.serve_plan(ARCHITECTURES[arch], shape)
    B, T = shape.global_batch, max(plan.cache_len, 1)
    jcache = jax.eval_shape(functools.partial(
        jreg.build_model(JARCH[arch]).init_cache, B, T))
    tcache = build_model(ARCHITECTURES[arch], device="meta").init_cache(B, T)
    assert _by_path(jax.tree.map(lambda a: a.shape, jcache)) == \
        _by_path(pytree.tree_map(lambda a: tuple(a.shape), tcache))
    m = _fake_mesh(MESHES[mesh])
    want = jsh.cache_specs(jcache, JARCH[arch], m, shard_cache_seq=seq)
    got = sh.cache_specs(tcache, ARCHITECTURES[arch], m, shard_cache_seq=seq)
    assert _by_path(got) == _by_path(jax.tree.map(
        tuple, want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))


def test_cache_shard_cuts_each_leaf_to_its_block():
    cfg = ARCHITECTURES["whisper-large-v3"].reduced()
    cache = build_model(cfg, device="cpu").init_cache(4, 8)
    cache = pytree.tree_map(lambda t: torch.arange(t.numel()).reshape(
        t.shape).to(t.dtype), cache)
    mesh = grp.MetaMesh(*MESH, (1, 1))
    held = sh.cache_shard(cache, mesh, cfg)
    # (L, B, T, H, Dh): rows 2-3 (data index 1), heads of model index 1
    h = cfg.num_heads // 2
    assert torch.equal(held["xk"], cache["xk"][:, 2:4, :, h:])
    assert torch.equal(held["k"], cache["k"][:, 2:4, :, cfg.num_kv_heads
                                             // 2:])
    assert torch.equal(held["length"], cache["length"])
    seq = sh.cache_shard(cache, mesh, cfg, shard_cache_seq=True)
    assert torch.equal(seq["k"], cache["k"][:, 2:4, 4:])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_plan_equals_the_reference(arch):
    for name in SHAPES:
        got = steps.serve_plan(ARCHITECTURES[arch], SHAPES[name])
        want = jsteps.serve_plan(JARCH[arch], JSHAPES[name])
        assert (got.run, got.cache_len, got.window, got.reason) == \
            (want.run, want.cache_len, want.window, want.reason)


# ---------------------------------------------------------------------------
# (f) params a rank on the production mesh
# ---------------------------------------------------------------------------
def _reference_elems(arch, mesh_shape):
    """Each leaf's elements a device under the reference's
    ``param_specs`` for its training parallelism: ``{path: elems}``."""
    cfg = JARCH[arch]
    from repro.configs.base import ParallelConfig as JParallel
    par = JParallel(shard_params_over_data=dryrun.parallel_for(
        arch, "train").shard_params_over_data)
    params = jax.eval_shape(jreg.build_model(cfg).init,
                            jax.random.PRNGKey(0))
    specs = jsh.param_specs(params, cfg, par, _fake_mesh(mesh_shape))
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_leaves(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))):
        n = int(np.prod(leaf.shape))
        for entry in spec:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    n //= mesh_shape[ax]
        out[jsh._path_str(path)] = n
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_params_a_rank_equal_the_reference_layout(arch):
    mesh, _ = __import__("repro_torch.launch.mesh",
                         fromlist=["x"]).make_production_mesh()
    cfg = ARCHITECTURES[arch]
    step = steps.build_train_step(cfg, SHAPES["train_4k"],
                                  dryrun.parallel_for(arch, "train"),
                                  CollectiveConfig(), mesh, device="meta")
    held = step.init(None)
    want = _reference_elems(arch, dict(mesh.shape))
    if cfg.family != "moe":
        assert sum(t.numel() for t in pytree.leaves(held)) == \
            sum(want.values())
        return
    experts = sum(t.numel() for layer in held["layers"]
                  for n, t in layer["moe"].items() if n in sh.EXPERT_LEAVES)
    assert experts == sum(n for p, n in want.items()
                          if p.rsplit("/", 1)[-1] in sh.EXPERT_LEAVES
                          and "dense" not in p)
