"""The port's FSDP training step against the JAX package's.

The reference runs in one subprocess with
``--xla_force_host_platform_device_count=4``: its untuned
``build_train_step`` with ``ParallelConfig(shard_params_over_data=True,
compute_dtype="float32")`` (``param_specs`` splits each weight over the
data axes together, XLA gathers it and reduce-scatters its gradient),
fp32 compute, ``warmup_steps=0``, on a ``("pod", "data")`` 2x2 or a
``("data",)`` 4 mesh. The port runs the same step in one spawned 4-rank
``gloo`` group, each rank holding its `sharding.fsdp_shard` of the
reference's params (``repro_torch.bridge``) and its rows of the 8 x 32
global batch. This file holds the families that go through the dense
stack (smollm-135m, llava-next-mistral-7b, olmoe-1b-7b without a
``model`` axis); ``tests/test_torch_fsdp_families.py`` holds mamba2,
zamba2 and whisper.

- The layout: for every leaf of every family and 2 and 4 data ranks,
  `sharding.fsdp_dim` is the dimension at which ``param_specs`` puts
  the data axes (full and reduced configs), and `fsdp_held_dim` reads
  it back off the shard.
- `group.reduce_scatter` and `sharding.data_axis` on a remapped 2x2
  mesh: the block a rank gets, and the order of a gather, follow
  `sharding.dp_index`.
- One step against the reference's: the loss within 1e-5, step 0's
  synced gradients (gathered whole) within 1e-3 of each leaf's scale,
  each leaf's change within 1e-2 (relative 2-norm); the replicated
  leaves bit-equal on every rank; each family shards its main leaves.
- One step against the port's own ``"xla"`` step without FSDP on the
  same mesh: the loss bit-equal, the synced gradients within 1e-6 of
  each leaf's scale (the reduce-scatter sums in another order than the
  all-reduce).
- Each fault of `steps.planted_fsdp_fault` reads above the gradient
  tolerance.
- ``--ckpt`` under FSDP writes whole leaves; FSDP with
  ``--model-parallel 2`` trains (``tests/test_torch_fsdp_model.py``
  holds that composition to the reference).
"""
import functools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHITECTURES as JARCH  # noqa: E402
from repro.configs.base import ParallelConfig as JParallel  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHITECTURES, ParallelConfig  # noqa: E402
from repro_torch.core.collectives import group as grp  # noqa: E402
from repro_torch.launch.steps import FSDP_FAULTS  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

from test_torch_tp import inputs, port_flat  # noqa: E402

HERE = os.path.dirname(__file__)
ROOT = os.path.join(HERE, "..")
GRAD_TOL = 1e-3          # |got - want| / max|want|, a leaf
LOSS_TOL = 1e-5
CHANGE_TOL = 1e-2        # |d_got - d_want| / |d_want| (2-norms), a leaf
SELF_TOL = 1e-6          # FSDP against the port's step without it
BF16_TOL = 2e-2          # gather_in_compute_dtype against the reference's
SEQ, BATCH = 32, 8
FSDP = ParallelConfig(shard_params_over_data=True)
LAYOUT_ARCHS = ("smollm-135m", "qwen2.5-3b", "llava-next-mistral-7b",
                "olmoe-1b-7b", "mamba2-130m", "zamba2-2.7b",
                "whisper-large-v3")
# (tag, arch, mesh, gather in bf16, faults planted, per-rank oracle):
# both meshes appear. The MoE family's oracle is per rank: the
# reference's program routes the global batch as one group (its expert
# capacity and load-balance loss over all 256 tokens), each port rank
# its own rows, with or without FSDP; so olmoe is held to the mean over
# the data ranks of the reference's loss and gradients on each rank's
# rows, and to the reference's AdamW step on that mean
CASES = (("smollm", "smollm-135m", "2x2", False, True, False),
         ("llava", "llava-next-mistral-7b", "4", False, False, False),
         ("olmoe", "olmoe-1b-7b", "2x2", False, False, True))

REF_SCRIPT = r"""
import json, os, sys
cfg_in = json.load(open(sys.argv[1]))
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from repro import compat
from repro.configs import get_config
from repro.configs.base import CollectiveConfig, ParallelConfig, ShapeConfig
from repro.launch import steps as rsteps
from repro.launch.steps import build_train_step
from repro.models.registry import build_model, make_train_batch
from repro.optim import AdamW, cosine_with_warmup
from repro.parallel import sharding as sh

def flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}

shape = ShapeConfig(name="fsdp", seq_len=cfg_in["seq"],
                    global_batch=cfg_in["batch"], kind="train")
# the step builds its model in the default (bf16) compute dtype, whatever
# ParallelConfig says: here it computes in fp32
rsteps.build_model = lambda c, **kw: build_model(
    c, compute_dtype=jnp.float32, **kw)
out = {}
for tag, arch, mesh_kind, bf16_gather, _, per_rank in cfg_in["cases"]:
    mesh = compat.make_mesh((2, 2), ("pod", "data")) if mesh_kind == "2x2" \
        else compat.make_mesh((4,), ("data",))
    cfg = get_config(arch).reduced()
    batch = make_train_batch(cfg, shape, seed=7)
    params = build_model(cfg, attn_impl="xla").init(jax.random.PRNGKey(2))
    out.update({f"{arch}|params|{k}": v for k, v in flat(params).items()})
    out.update({f"{arch}|batch|{k}": np.asarray(v, np.float32)
                if jnp.issubdtype(v.dtype, jnp.floating) else np.asarray(v)
                for k, v in batch.items()})      # numpy has no bfloat16
    if per_rank:
        api = build_model(cfg, compute_dtype=jnp.float32, attn_impl="xla")
        vg = jax.jit(jax.value_and_grad(lambda p, b: api.loss(p, b)[0]))
        n = cfg_in["batch"] // 4
        parts = [vg(params, {k: v[i * n:(i + 1) * n]
                             for k, v in batch.items()}) for i in range(4)]
        loss = sum(l for l, _ in parts) / 4
        g = jax.tree.map(lambda *gs: sum(gs) / 4, *[g for _, g in parts])
        opt = AdamW(lr=3e-4)
        new_p, _ = opt.update(g, opt.init(params), params,
                              lr_scale=cosine_with_warmup(
                                  0, warmup_steps=0, total_steps=1000))
        for key in (f"{tag}|loss", f"{tag}|step|loss"):
            out[key] = np.asarray(loss)
        out.update({f"{tag}|grad|{k}": v for k, v in flat(g).items()})
        out.update({f"{tag}|step|params|{k}": v
                    for k, v in flat(new_p).items()})
        continue
    parallel = ParallelConfig(shard_params_over_data=True,
                              compute_dtype="float32",
                              gather_in_compute_dtype=bf16_gather)
    fn, _, in_sh, out_sh, _ = build_train_step(
        cfg, shape, parallel, CollectiveConfig(), mesh, warmup_steps=0)
    placed = jax.device_put(params, in_sh[0])
    api = build_model(cfg, compute_dtype=jnp.float32, attn_impl="xla")

    def loss_fn(p, b):
        if bf16_gather:         # the step's cast (its loss_with_cast)
            p = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                             if x.dtype == jnp.float32 else x, p)
        return api.loss(p, b)[0]
    loss, g = jax.jit(jax.value_and_grad(loss_fn))(placed, batch)
    out[f"{tag}|loss"] = np.asarray(loss)
    out.update({f"{tag}|grad|{k}": v for k, v in flat(g).items()})
    opt = jax.device_put(AdamW(lr=3e-4).init(params), in_sh[1])
    new_p, _, m = jax.jit(fn, in_shardings=in_sh,
                          out_shardings=out_sh)(placed, opt, batch)
    out[f"{tag}|step|loss"] = np.asarray(m["loss"])
    out.update({f"{tag}|step|params|{k}": v
                for k, v in flat(jax.device_get(new_p)).items()})
    sh.set_current_mesh(None)
np.savez(cfg_in["out"], **out)
print("ok")
"""


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------
def _leaf_keys(arch):
    """Every leaf of the reduced port model, layers collapsed
    ('layers/attn/wq')."""
    params = build_model(ARCHITECTURES[arch].reduced(), device="cpu").init(
        torch.Generator().manual_seed(0))
    keys = []

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], prefix + (k,))
        elif isinstance(t, list):
            walk(t[0], prefix)
        else:
            keys.append("/".join(prefix))
    walk(params, ())
    return keys


LEAVES = [(arch, key) for arch in LAYOUT_ARCHS for key in _leaf_keys(arch)]


@functools.lru_cache(maxsize=None)
def _reference_layout(arch, dp, reduced):
    """``{key: (shape, spec)}`` of the reference's params under FSDP over
    ``dp`` data ranks, stacked."""
    cfg = JARCH[arch].reduced() if reduced else JARCH[arch]
    shapes = jax.eval_shape(
        lambda: jbuild(cfg).init(jax.random.PRNGKey(0)))
    mesh = types.SimpleNamespace(shape={"data": dp, "model": 1},
                                 axis_names=("data", "model"))
    specs = jsh.param_specs(shapes, cfg,
                            JParallel(shard_params_over_data=True), mesh)
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(shapes)[0],
            jax.tree_util.tree_leaves(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = (tuple(leaf.shape), tuple(spec))
    return out


@pytest.mark.parametrize("dp", (2, 4))
@pytest.mark.parametrize("arch,key", LEAVES)
def test_fsdp_dim_is_where_param_specs_puts_the_data_axes(arch, key, dp):
    for reduced in (True, False):
        cfg = ARCHITECTURES[arch].reduced() if reduced \
            else ARCHITECTURES[arch]
        shape, spec = _reference_layout(arch, dp, reduced)[key]
        path = tuple(key.split("/"))
        off = 1 if path[0] in bridge.STACKED else 0
        at = [i for i, e in enumerate(spec) if e in (("data",), "data")]
        want = at[0] - off if at else None
        full = shape[off:]
        assert sh.fsdp_dim(path, full, dp) == want, \
            (key, reduced, shape, spec)
        held = list(full)
        if want is not None:
            held[want] //= dp
        assert sh.fsdp_held_dim(path, tuple(held), cfg, dp) == want, key


def _remapped_collectives():
    """On a 2x2 ``("pod", "data")`` mesh built in a shuffled rank order:
    this rank's `data_axis` index, its `dp_index`, what it gets of a
    reduce-scatter of rows (r + 1) * [0, 1, 2, 3] (block i = row i) and
    the order of a gather of its index."""
    mesh = grp.RankMesh((2, 2), ("pod", "data"), device_order=[2, 0, 3, 1])
    axis = sh.data_axis(mesh)
    r = grp.rank()
    x = (r + 1) * torch.arange(4, dtype=torch.float32).repeat_interleave(3)
    got = grp.reduce_scatter(x, axis)
    order = grp.all_gather(torch.tensor([sh.dp_index(mesh)]), axis)
    return {"index": grp.rank(axis), "dp_index": sh.dp_index(mesh),
            "block": got.tolist(), "order": order.tolist(),
            "group_is_default": axis.group is None}


def _all_ranks(fn):
    parts = [None] * grp.size()
    torch.distributed.all_gather_object(parts, fn())
    return parts


def test_reduce_scatter_and_the_data_axis_follow_dp_index():
    got = grp.spawn(_all_ranks, 4, (_remapped_collectives,), timeout_s=120)
    total = sum(range(1, 5))
    for r in got:
        assert r["index"] == r["dp_index"] and r["group_is_default"]
        assert r["block"] == [total * r["dp_index"]] * 3
        assert r["order"] == [0, 1, 2, 3]
    assert sorted(r["dp_index"] for r in got) == [0, 1, 2, 3]
    # slot i holds rank device_order[i]: rank 0 sits at slot 1
    assert got[0]["dp_index"] == 1 and got[2]["dp_index"] == 0


# ---------------------------------------------------------------------------
# one step, the reference in a subprocess and the port in one group
# ---------------------------------------------------------------------------
def _count_sharded(tree, cfg, dp) -> int:
    return sum(d is not None for d in sh.fsdp_dims(tree, cfg, dp))


def rank_work(ref_path, out_dir, cases):
    """Every case's FSDP step (and, at fp32 gathers, the port's step
    without FSDP and the planted faults) in this rank: its loss,
    replicas check, and step 0's synced gradients and new params
    gathered whole, into ``out_dir/r{rank}.npz``."""
    import contextlib

    from repro_torch import pytree
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.base import CollectiveConfig
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_local_mesh

    ref = dict(np.load(ref_path))
    meshes = {"2x2": make_local_mesh(1, pods=2, device="cpu"),
              "4": make_local_mesh(1, device="cpu")}
    out = {}
    shape = ShapeConfig(name="fsdp", seq_len=SEQ, global_batch=BATCH,
                        kind="train")
    for tag, arch, mesh_kind, bf16_gather, faults, _ in cases:
        cfg = ARCHITECTURES[arch].reduced()
        mesh = meshes[mesh_kind]
        full, batch = inputs(ref, arch, sh.batch_rows(mesh, BATCH))
        fsdp = ParallelConfig(shard_params_over_data=True,
                              compute_dtype="float32",
                              gather_in_compute_dtype=bf16_gather)
        variants = {"fsdp": (fsdp, None)}
        if not bf16_gather:
            variants["plain"] = (ParallelConfig(compute_dtype="float32"),
                                 None)
        if faults:
            variants.update({f: (fsdp, f) for f in FSDP_FAULTS})
        for name, (parallel, fault) in variants.items():
            step = steps.build_train_step(
                cfg, shape, parallel, CollectiveConfig(), mesh,
                warmup_steps=0, device="cpu")
            p = pytree.tree_map(torch.clone, full)   # updated in place
            if step.fsdp:
                p = sh.fsdp_shard(p, mesh)
                out[f"{tag}|sharded"] = np.asarray(
                    _count_sharded(p, cfg, sh.dp_size(mesh)))
            plant = steps.planted_fsdp_fault(fault) if fault \
                else contextlib.nullcontext()
            with plant:
                new_p, _, m = step.fn(p, step.opt.init(p), batch,
                                      keep_grads=True)
            key = f"{tag}|{name}"
            out[f"{key}|loss"] = np.asarray(m["loss"].numpy())
            out[f"{key}|replicas"] = np.asarray(train._replicas(new_p,
                                                                step))
            if step.fsdp:
                out[f"{key}|collectives"] = np.asarray(
                    [m["collectives"][k] for k in
                     ("gathers", "reduce_scatters", "all_reduces")])
            for k, v in port_flat(step.gather(m["grads"])).items():
                out[f"{key}|grad|{k}"] = v
            for k, v in port_flat(step.gather(new_p)).items():
                out[f"{key}|params|{k}"] = v
    np.savez(os.path.join(out_dir, f"r{grp.rank()}.npz"), **out)


def run_cases(tmp, cases):
    """The reference's and the port's runs of ``cases``."""
    cfg = {"seq": SEQ, "batch": BATCH, "cases": [list(c) for c in cases],
           "out": str(tmp / "ref.npz")}
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "cfg.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        out, err = ref_proc.communicate(timeout=600)
    finally:
        ref_proc.kill()
    assert ref_proc.returncode == 0, out + err[-4000:]
    grp.spawn(rank_work, 4, (cfg["out"], str(tmp), cases), timeout_s=300)
    return types.SimpleNamespace(
        ref=dict(np.load(cfg["out"])),
        port=[dict(np.load(tmp / f"r{r}.npz")) for r in range(4)])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("fsdp"), CASES)


def grad_readings(port, key, want_prefix, ref):
    """|got - want| / max|want| per leaf of ``port``'s gradients under
    ``key`` against ``ref``'s under ``want_prefix``."""
    read = {}
    prefix = f"{key}|grad|"
    keys = [k for k in port if k.startswith(prefix)]
    assert keys
    for k in keys:
        leaf = k[len(prefix):]
        want = ref[f"{want_prefix}|{leaf}"]
        got = port[k]
        assert got.shape == want.shape, (k, got.shape, want.shape)
        scale = float(np.abs(want).max()) or 1.0
        read[leaf] = float(np.abs(got - want).max()) / scale
    return read


def change_readings(port, key, tag, arch, ref):
    """|d_got - d_want| / |d_want| (2-norms) per leaf, d the change of
    the params over the step."""
    read = {}
    prefix = f"{key}|params|"
    keys = [k for k in port if k.startswith(prefix)]
    assert keys
    for k in keys:
        leaf = k[len(prefix):]
        init = ref[f"{arch}|params|{leaf}"].astype(np.float64)
        want = ref[f"{tag}|step|params|{leaf}"].astype(np.float64) - init
        got = port[k].astype(np.float64) - init
        den = np.linalg.norm(want)
        assert den > 0, leaf
        read[leaf] = float(np.linalg.norm(got - want) / den)
    return read


def check_against_reference(run, case):
    """The FSDP step of ``case`` on every rank against the reference's
    step: loss, synced gradients, the params' change, replicas."""
    tag, arch = case[0], case[1]
    for port in run.port:
        assert abs(float(port[f"{tag}|fsdp|loss"]) -
                   float(run.ref[f"{tag}|step|loss"])) <= LOSS_TOL
        np.testing.assert_allclose(port[f"{tag}|fsdp|loss"],
                                   run.ref[f"{tag}|loss"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        assert bool(port[f"{tag}|fsdp|replicas"])
        read = grad_readings(port, f"{tag}|fsdp", f"{tag}|grad", run.ref)
        worst = max(read, key=read.get)
        assert read[worst] <= GRAD_TOL, (worst, read[worst])
        read = change_readings(port, f"{tag}|fsdp", tag, arch, run.ref)
        worst = max(read, key=read.get)
        assert read[worst] <= CHANGE_TOL, (worst, read[worst])


def check_against_plain(run, case):
    """The FSDP step of ``case`` against the port's step without FSDP:
    the loss bit-equal, the synced gradients within `SELF_TOL`."""
    tag = case[0]
    for port in run.port:
        assert port[f"{tag}|fsdp|loss"].tobytes() == \
            port[f"{tag}|plain|loss"].tobytes()
        assert bool(port[f"{tag}|plain|replicas"])
        read = grad_readings(port, f"{tag}|fsdp", f"{tag}|plain|grad", port)
        worst = max(read, key=read.get)
        assert read[worst] <= SELF_TOL, (worst, read[worst])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fsdp_step_matches_the_reference(run, case):
    check_against_reference(run, case)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fsdp_step_matches_the_step_without_fsdp(run, case):
    check_against_plain(run, case)


# each family's sharded leaves at its reduced widths (d 256, dp 4): the
# embeddings' two, and per layer the attention's four and the dense
# MLP's three (llava: 2 layers), or the router and the experts' three
SHARDED = {"smollm": 2 + 2 * 7, "llava": 2 + 2 * 7, "olmoe": 2 + 2 * 8}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_each_family_shards_its_main_leaves(run, case):
    tag = case[0]
    for port in run.port:
        assert int(port[f"{tag}|sharded"]) == SHARDED[tag]
        # one gather and one reduce-scatter for the rest of the tree and
        # one of each a layer
        gathers, scatters, _ = port[f"{tag}|fsdp|collectives"].tolist()
        assert gathers == scatters == 1 + 2


@pytest.mark.parametrize("fault", FSDP_FAULTS)
def test_each_planted_fault_fails_the_grad_check(run, fault):
    worst = max(max(grad_readings(port, f"smollm|{fault}", "smollm|grad",
                                  run.ref).values())
                for port in run.port)
    assert worst > GRAD_TOL, (fault, worst)


def test_checkpoint_writes_whole_leaves(tmp_path):
    """``--ckpt`` under FSDP: rank 0 writes whole leaves (params and
    Adam's moments) under the reference's keys, stacked over the layers,
    the kept params are whole, and `fsdp_dim` cuts a written leaf to a
    shard's shape."""
    from repro_torch import bridge, pytree
    from repro_torch.launch import train
    res = train.main(["--arch", "smollm-135m", "--reduced", "--device",
                      "cpu", "--topology", "2x2", "--steps", "1", "--seq",
                      "32", "--batch", "8", "--ckpt", str(tmp_path)],
                     keep_params=True, parallel=FSDP)
    assert res["fsdp"] == {"data_axes": ["pod", "data"],
                           "sharded_leaves": 16, "replicated_leaves": 5}
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    shapes = {r["key"]: r["shape"] for r in manifest["leaves"]}
    d = 256
    assert shapes["params/embed/tok"] == [1024, d]
    assert shapes["params/layers/attn/wo"] == [2, 4, 64, d]
    assert shapes["opt/.mu/layers/mlp/w_up"] == [2, d, 512]     # Adam's mu
    arrays = np.load(tmp_path / "arrays.npz")
    cut = 0
    for path, key, layer, whole in bridge.reference_leaves(res["params"]):
        written = arrays[f"params__{key.replace('/', '__')}"]
        if layer is not None:
            written = written[layer]
        np.testing.assert_array_equal(written, whole.numpy(), err_msg=key)
        dim = sh.fsdp_dim(path, written.shape, 4)
        if dim is not None:
            cut += 1
            shard = np.take(written, range(written.shape[dim] // 4),
                            axis=dim)
            assert sh.fsdp_held_dim(path, shard.shape,
                                    ARCHITECTURES["smollm-135m"].reduced(),
                                    4) == dim
    assert cut == 16
    # a rank holds a quarter of each sharded leaf
    assert res["param_elems"] < sum(
        t.numel() for t in pytree.leaves(res["params"]))


def test_fsdp_with_a_model_axis_raises_naming_its_step():
    """FSDP with ``--model-parallel 2`` (the name is the test's from when
    it raised): one step of the reduced smollm on ``("data", "model")``
    = 2 x 2, each rank holding its tensor-parallel slices cut to its FSDP
    shard; every leaf equal on the ranks that hold the same part of it,
    and the fsdp block counts the leaves by the halves that cut them."""
    from repro_torch.launch import train
    res = train.main(["--reduced", "--device", "cpu", "--ranks", "4",
                      "--model-parallel", "2", "--steps", "1", "--seq",
                      "32", "--batch", "8"], parallel=FSDP)
    assert res["mesh"] == {"data": 2, "model": 2}
    assert res["layout"] == "fsdp+tp"
    # the embeddings and each layer's wq, wo and MLP cut by both halves;
    # the one kv head's wk, wv sharded over data only; the norms whole
    assert res["fsdp"] == {"data_axes": ["data"], "sharded_leaves": 16,
                           "replicated_leaves": 5, "model_axis": "model",
                           "leaves": {"data": 4, "model": 0, "both": 12,
                                      "neither": 5}}
    assert res["replicas_equal_at_init"] and all(res["replicas_equal"])
    assert len(res["losses"]) == 1 and 0 < res["losses"][0] < 20
    c = res["collectives"]
    assert c["gathers"] == c["reduce_scatters"] == 3
    assert c["model_all_reduces"] > 0 and res["model_s"][0] > 0
