"""FSDP composed with the ``model`` axis in training, against the JAX
package: both halves of ``param_specs`` at once, tensor parallelism for
every family without experts and expert parallelism for the MoE one.

The reference runs in one subprocess with
``--xla_force_host_platform_device_count=4``: its untuned
``build_train_step`` with ``ParallelConfig(shard_params_over_data=True,
compute_dtype="float32")`` on a ``("data", "model")`` 2x2 mesh (each
weight split over ``model`` on its heads, FFN columns, vocab or experts
and over ``data`` on ``d``), fp32 compute, ``warmup_steps=0``. It writes
the params and batches first, so the port's group starts while it
compiles. The port runs the same step in one spawned 4-rank ``gloo``
group, each rank holding its `sharding.shard` of the reference's params
(``repro_torch.bridge``) and its data coordinate's rows of the 8 x 32
global batch.

- The layout: for every leaf of every family at dp 2 x tp 2,
  `sharding.fsdp_held_dim` and `tp_held_dim` read back, off the leaf cut
  by both halves, the dimensions at which ``param_specs`` puts the data
  axes and ``"model"`` (full and reduced configs). The MoE family splits
  only its experts over ``model`` (expert parallelism keeps the
  attention and embeddings whole on every model rank, as without FSDP).
- `sharding.data_axis` on remapped ``("data", "model")`` and ``("pod",
  "data", "model")`` meshes: the ranks of this rank's model coordinate,
  in `dp_index` order.
- One step of qwen2.5-3b (the mixed layout: 4 query heads split, its
  one kv head whole), whisper-large-v3 (encoder, decoder and
  cross-attention), zamba2-2.7b (the shared block), mamba2-130m (the SSM
  projections replicated over ``model``) and olmoe-1b-7b (expert
  parallelism) against the reference's: the loss within 1e-5, step 0's
  synced gradients (gathered whole) within 1e-3 of each leaf's scale,
  each leaf's change within 1e-2 (relative 2-norm), the clip's norm
  within 1e-3 of the norm of the reference's whole gradient; each leaf
  equal on the ranks that hold the same part of it. olmoe is held to the
  reference's own FSDP step: on a ``model`` axis the reference routes
  each rank's sequence chunk of its rows as one group (its nested expert
  ``shard_map``), as the port does.
- One step against the port's ``"xla"`` step without FSDP on the same
  mesh: the loss bit-equal, the synced gradients within 1e-6.
- Each fault planted in qwen's step reads above the gradient tolerance:
  `steps.FSDP_FAULTS`, ``"copy_not_summed"`` of `steps.TP_FAULTS`, and
  ``"norm_one_axis"`` (the clip's norm summed over ``model`` only for
  the leaves cut by both halves), which shows in the norm.
- ``--ckpt`` under FSDP + TP and FSDP + EP writes whole leaves, equal to
  the same run's kept params gathered whole.
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
from repro_torch.launch.steps import FSDP_FAULTS, NORM_FAULTS  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

from test_torch_fsdp import (  # noqa: E402
    GRAD_TOL,
    SELF_TOL,
    _leaf_keys,
    change_readings,
    check_against_plain,
    grad_readings,
)
from test_torch_tp import inputs, port_flat  # noqa: E402

HERE = os.path.dirname(__file__)
ROOT = os.path.join(HERE, "..")
LOSS_TOL = 1e-5
CHANGE_TOL = 1e-2
SEQ, BATCH = 32, 8
FSDP = ParallelConfig(shard_params_over_data=True)
# (tag, arch, faults planted)
CASES = (("qwen", "qwen2.5-3b", True),
         ("whisper", "whisper-large-v3", False),
         ("zamba2", "zamba2-2.7b", False),
         ("mamba2", "mamba2-130m", False),
         ("olmoe", "olmoe-1b-7b", False))
FAULTS = (*FSDP_FAULTS, "copy_not_summed", *NORM_FAULTS)
# each family's leaves by the halves that cut them at its reduced widths
# (d 256, 4 heads, ff 512, 4 experts; dp 2 x tp 2): qwen's one kv head
# stays whole over model (wk, wv sharded over data only; bk, bv whole),
# its bq split over model only; the SSM projections are whole over model
KINDS = {"qwen": {"data": 4, "model": 2, "both": 12, "neither": 9},
         "whisper": {"data": 0, "model": 0, "both": 34, "neither": 25},
         "zamba2": {"data": 4, "model": 0, "both": 9, "neither": 17},
         "mamba2": {"data": 4, "model": 0, "both": 2, "neither": 15},
         "olmoe": {"data": 12, "model": 0, "both": 6, "neither": 5}}
# the rest of the tree's gather point and one a layer (whisper: 2 + 2)
GATHERS = {"qwen": 3, "whisper": 5, "zamba2": 3, "mamba2": 3, "olmoe": 3}

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
from repro.optim import AdamW
from repro.parallel import sharding as sh

def flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}

shape = ShapeConfig(name="fsdp_model", seq_len=cfg_in["seq"],
                    global_batch=cfg_in["batch"], kind="train")
mesh = compat.make_mesh((2, 2), ("data", "model"))
# the params and batches first: the port's group starts on them
drawn, out = {}, {}
for tag, arch, _ in cfg_in["cases"]:
    cfg = get_config(arch).reduced()
    batch = make_train_batch(cfg, shape, seed=7)
    params = build_model(cfg, attn_impl="xla").init(jax.random.PRNGKey(2))
    drawn[tag] = (cfg, params, batch)
    out.update({f"{arch}|params|{k}": v for k, v in flat(params).items()})
    out.update({f"{arch}|batch|{k}": np.asarray(v, np.float32)
                if jnp.issubdtype(v.dtype, jnp.floating) else np.asarray(v)
                for k, v in batch.items()})      # numpy has no bfloat16
np.savez(cfg_in["params"], **out)
print("params", flush=True)
# the step builds its model in the default (bf16) compute dtype, whatever
# ParallelConfig says: here it computes in fp32
rsteps.build_model = lambda c, **kw: build_model(
    c, compute_dtype=jnp.float32, **kw)
out = {}
for tag, arch, _ in cfg_in["cases"]:
    cfg, params, batch = drawn[tag]
    parallel = ParallelConfig(shard_params_over_data=True,
                              compute_dtype="float32")
    fn, _, in_sh, out_sh, _ = build_train_step(
        cfg, shape, parallel, CollectiveConfig(), mesh, warmup_steps=0)
    placed = jax.device_put(params, in_sh[0])
    ep = {"ep_axis": "model", "mesh": mesh} if cfg.family == "moe" else {}
    api = build_model(cfg, compute_dtype=jnp.float32, attn_impl="xla",
                      **ep)
    (loss, aux), g = jax.jit(jax.value_and_grad(api.loss, has_aux=True))(
        placed, batch)
    out[f"{tag}|loss"] = np.asarray(loss)
    out.update({f"{tag}|aux|{k}": np.asarray(v) for k, v in aux.items()})
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
LAYOUT_ARCHS = ("qwen2.5-3b", "llava-next-mistral-7b", "whisper-large-v3",
                "zamba2-2.7b", "mamba2-130m", "olmoe-1b-7b")
LEAVES = [(arch, key) for arch in LAYOUT_ARCHS for key in _leaf_keys(arch)]


@functools.lru_cache(maxsize=None)
def _reference_layout(arch, reduced):
    """``{key: (shape, spec)}`` of the reference's params under FSDP on a
    ``("data", "model")`` 2 x 2 mesh, stacked."""
    cfg = JARCH[arch].reduced() if reduced else JARCH[arch]
    shapes = jax.eval_shape(lambda: jbuild(cfg).init(jax.random.PRNGKey(0)))
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2},
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


def _mesh(dp=2, tp=2):
    """What `sharding.held_kinds` reads of a mesh: its axes' sizes."""
    return types.SimpleNamespace(shape={"data": dp, "model": tp},
                                 axis_names=("data", "model"))


@pytest.mark.parametrize("arch,key", LEAVES)
def test_held_dims_are_where_param_specs_puts_both_halves(arch, key):
    for reduced in (True, False):
        cfg = ARCHITECTURES[arch].reduced() if reduced \
            else ARCHITECTURES[arch]
        shape, spec = _reference_layout(arch, reduced)[key]
        path = tuple(key.split("/"))
        off = 1 if path[0] in bridge.STACKED else 0
        full = shape[off:]
        data_at = [i - off for i, e in enumerate(spec)
                   if e in (("data",), "data")]
        model_at = [i - off for i, e in enumerate(spec) if e == "model"]
        want_d = data_at[0] if data_at else None
        want_m = model_at[0] if model_at else None
        moe = cfg.family == "moe"
        if moe:
            # expert parallelism splits only the experts over model, on E
            expert = sh._is_expert(path)
            assert not expert or want_m == 0, (key, spec)
            want_m = 0 if expert else None
        assert want_d is None or want_d != want_m, key
        assert sh.fsdp_dim(path, full, 2) == want_d, (key, reduced, spec)
        if not moe:
            assert sh.tp_dim(path, full, 2) == want_m, (key, reduced, spec)
        held = list(full)
        for d in (want_d, want_m):
            if d is not None:
                held[d] //= 2
        held = tuple(held)
        assert sh.fsdp_held_dim(path, held, cfg, 2) == want_d, (key, held)
        if not moe:
            assert sh.tp_held_dim(path, held, cfg, 2) == want_m, (key, held)
        model = ("model",) if want_m is not None else ()
        data = ("data",) if want_d is not None else ()
        assert sh.held_kinds(path, held, cfg, _mesh(), True) == \
            model + data, key
        assert sh.held_kinds(path, held, cfg, _mesh(), False) == model, key


def _remapped_data_axes():
    """On ``("data", "model")`` 2 x 2 and ``("pod", "data", "model")`` 2 x
    1 x 2 meshes built in shuffled rank orders: this rank's model
    coordinate, `dp_index`, `data_axis` index, the ranks of its
    `data_axis` (gathered in axis order), its block of a reduce-scatter
    of rows (r + 1) * [0, 1] (block i = row i)."""
    out = []
    for shape, names, order in (((2, 2), ("data", "model"), [2, 0, 3, 1]),
                                ((2, 1, 2), ("pod", "data", "model"),
                                 [1, 3, 0, 2])):
        mesh = grp.RankMesh(shape, names, device_order=order)
        axis = sh.data_axis(mesh)
        r = grp.rank()
        x = (r + 1) * torch.arange(2, dtype=torch.float32)\
            .repeat_interleave(3)
        out.append({"model": grp.rank(mesh.axis("model")),
                    "dp_index": sh.dp_index(mesh),
                    "index": grp.rank(axis),
                    "ranks": grp.all_gather(torch.tensor([r]), axis)
                    .tolist(),
                    "block": grp.reduce_scatter(x, axis).tolist(),
                    "slots": [int(s) for s in
                              np.argwhere(mesh.ranks == r)[0]]})
    return out


def _all_ranks(fn):
    parts = [None] * grp.size()
    torch.distributed.all_gather_object(parts, fn())
    return parts


def test_the_data_axis_is_this_model_coordinates_data_ranks():
    got = grp.spawn(_all_ranks, 4, (_remapped_data_axes,), timeout_s=120)
    for m in range(2):          # the two meshes
        by_rank = {r: got[r][m] for r in range(4)}
        for r, me in by_rank.items():
            assert me["index"] == me["dp_index"]
            peers = [q for q, o in by_rank.items()
                     if o["model"] == me["model"]]
            # the axis holds exactly the ranks of this model coordinate,
            # in dp_index order
            assert sorted(me["ranks"]) == sorted(peers), (m, r)
            assert [by_rank[q]["dp_index"] for q in me["ranks"]] == [0, 1]
            total = sum(q + 1 for q in peers)
            assert me["block"] == [total * me["dp_index"]] * 3
        assert sorted((o["model"], o["dp_index"])
                      for o in by_rank.values()) == \
            [(0, 0), (0, 1), (1, 0), (1, 1)]
    # slot i holds rank device_order[i]: on the 2 x 2 mesh rank 0 sits at
    # slot 1 = (data 0, model 1)
    assert got[0][0]["slots"] == [0, 1] and got[0][0]["model"] == 1


# ---------------------------------------------------------------------------
# one step, the reference in a subprocess and the port in one group
# ---------------------------------------------------------------------------
def rank_work(params_path, out_dir):
    """Every case's FSDP step on the 2 x 2 mesh, the same step without
    FSDP, and (qwen) the planted faults, in this rank: the loss, aux,
    replicas, the clip's norm, the collectives, the kinds of leaf, and
    step 0's synced gradients and new params gathered whole, into
    ``out_dir/r{rank}.npz``."""
    import contextlib

    from repro_torch import pytree
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.base import CollectiveConfig
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_local_mesh

    ref = dict(np.load(params_path))
    mesh = make_local_mesh(2, device="cpu")
    out = {"model": np.asarray(grp.rank(mesh.axis("model")))}
    shape = ShapeConfig(name="fsdp_model", seq_len=SEQ, global_batch=BATCH,
                        kind="train")
    fsdp = ParallelConfig(shard_params_over_data=True,
                          compute_dtype="float32")
    plain = ParallelConfig(compute_dtype="float32")
    for tag, arch, faults in CASES:
        cfg = ARCHITECTURES[arch].reduced()
        full, batch = inputs(ref, arch, sh.batch_rows(mesh, BATCH))
        variants = {"fsdp": (fsdp, None), "plain": (plain, None)}
        if faults:
            variants.update({f: (fsdp, f) for f in FAULTS})
        for name, (parallel, fault) in variants.items():
            step = steps.build_train_step(
                cfg, shape, parallel, CollectiveConfig(), mesh,
                warmup_steps=0, device="cpu")
            assert step.model_axis == "model"
            p = sh.shard(pytree.tree_map(torch.clone, full), mesh, cfg,
                         step.fsdp)
            if name == "fsdp":
                kinds = step.kinds(p)
                out[f"{tag}|kinds"] = np.asarray(
                    [len(pytree.leaves(kinds.get(k, {})))
                     for k in (("data",), ("model",), ("model", "data"),
                               ())])
            if fault in FSDP_FAULTS + NORM_FAULTS:
                plant = steps.planted_fsdp_fault(fault)
            elif fault:
                plant = steps.planted_tp_fault(fault)
            else:
                plant = contextlib.nullcontext()
            with plant:
                new_p, _, m = step.fn(p, step.opt.init(p), batch,
                                      keep_grads=True)
            key = f"{tag}|{name}"
            out[f"{key}|loss"] = np.asarray(m["loss"].numpy())
            out[f"{key}|ce"] = np.asarray(float(m.get("ce", m["loss"])))
            out[f"{key}|gnorm"] = np.asarray(float(m["grad_norm"]))
            out[f"{key}|replicas"] = np.asarray(train._replicas(new_p, step))
            if step.fsdp:
                c = m["collectives"]
                out[f"{key}|collectives"] = np.asarray(
                    [c[k] for k in ("gathers", "reduce_scatters",
                                    "all_reduces", "model_all_reduces",
                                    "model_all_to_alls")])
            for k, v in port_flat(step.gather(m["grads"])).items():
                out[f"{key}|grad|{k}"] = v
            for k, v in port_flat(step.gather(new_p)).items():
                out[f"{key}|params|{k}"] = v
    np.savez(os.path.join(out_dir, f"r{grp.rank()}.npz"), **out)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_model")
    cfg = {"seq": SEQ, "batch": BATCH, "cases": [list(c) for c in CASES],
           "params": str(tmp / "params.npz"), "out": str(tmp / "ref.npz")}
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    with open(tmp / "ref.err", "w") as err:
        ref_proc = subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, str(tmp / "cfg.json")],
            env=env, stdout=subprocess.PIPE, stderr=err, text=True,
            cwd=ROOT)
        try:
            first = ref_proc.stdout.readline()
            if first.strip() == "params":
                # the port's group runs while the reference compiles
                grp.spawn(rank_work, 4, (cfg["params"], str(tmp)),
                          timeout_s=300)
            rest = ref_proc.communicate(timeout=600)[0]
        finally:
            ref_proc.kill()
    assert ref_proc.returncode == 0 and first.strip() == "params", \
        first + rest + (tmp / "ref.err").read_text()[-4000:]
    ref = {**np.load(cfg["params"]), **np.load(cfg["out"])}
    return types.SimpleNamespace(
        ref=ref, port=[dict(np.load(tmp / f"r{r}.npz")) for r in range(4)])


def _ref_norm(run, tag):
    """The 2-norm of the reference's whole gradient tree."""
    prefix = f"{tag}|grad|"
    return float(np.sqrt(sum(np.sum(np.square(v.astype(np.float64)))
                              for k, v in run.ref.items()
                              if k.startswith(prefix))))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fsdp_model_step_matches_the_reference(run, case):
    tag, arch = case[0], case[1]
    want_norm = _ref_norm(run, tag)
    # olmoe's cross-entropy is held here; its loss adds the aux losses,
    # which the reference returns from data rank 0 (test_torch_moe_ep's
    # _check_losses), the port averaged over the data ranks
    ref_loss = float(run.ref[f"{tag}|aux|ce"] if tag == "olmoe"
                     else run.ref[f"{tag}|loss"])
    for port in run.port:
        got = float(port[f"{tag}|fsdp|ce" if tag == "olmoe"
                         else f"{tag}|fsdp|loss"])
        assert abs(got - ref_loss) <= LOSS_TOL * max(1.0, abs(ref_loss))
        if tag != "olmoe":
            assert abs(float(port[f"{tag}|fsdp|loss"]) -
                       float(run.ref[f"{tag}|step|loss"])) <= LOSS_TOL * \
                max(1.0, ref_loss)
        assert bool(port[f"{tag}|fsdp|replicas"])
        read = grad_readings(port, f"{tag}|fsdp", f"{tag}|grad", run.ref)
        worst = max(read, key=read.get)
        assert read[worst] <= GRAD_TOL, (worst, read[worst])
        read = change_readings(port, f"{tag}|fsdp", tag, arch, run.ref)
        worst = max(read, key=read.get)
        assert read[worst] <= CHANGE_TOL, (worst, read[worst])
        got = float(port[f"{tag}|fsdp|gnorm"])
        assert abs(got - want_norm) <= GRAD_TOL * want_norm, (got, want_norm)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fsdp_model_step_matches_the_step_without_fsdp(run, case):
    check_against_plain(run, case)
    tag = case[0]
    for port in run.port:
        # the same norm, summed over other axes in another order
        a, b = (float(port[f"{tag}|{v}|gnorm"]) for v in ("fsdp", "plain"))
        assert abs(a - b) <= SELF_TOL * b


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_each_family_cuts_its_leaves_by_both_halves(run, case):
    tag = case[0]
    want = KINDS[tag]
    for port in run.port:
        assert port[f"{tag}|kinds"].tolist() == [
            want[k] for k in ("data", "model", "both", "neither")]
        gathers, scatters, _, model_ar, model_a2a = \
            port[f"{tag}|fsdp|collectives"].tolist()
        assert gathers == scatters == GATHERS[tag]
        # the blocks' all-reduces over model (and the MoE dispatch's
        # all-to-alls, two a layer and two in their backward)
        assert model_ar > 0
        assert model_a2a == (8 if tag == "olmoe" else 0)


@pytest.mark.parametrize("fault", FAULTS)
def test_each_planted_fault_fails_the_grad_check(run, fault):
    want = _ref_norm(run, "qwen")
    worst = 0.0
    for port in run.port:
        worst = max(worst, *grad_readings(port, f"qwen|{fault}",
                                          "qwen|grad", run.ref).values(),
                    abs(float(port[f"qwen|{fault}|gnorm"]) - want) / want)
    assert worst > GRAD_TOL, (fault, worst)


@pytest.mark.parametrize("arch", ("qwen2.5-3b", "olmoe-1b-7b"))
def test_checkpoint_writes_whole_leaves(tmp_path, arch):
    """``--ckpt`` under FSDP + TP (qwen) and FSDP + EP (olmoe) on 2 x 2:
    rank 0 writes whole leaves in the reference's format, each equal to
    the same run's kept params (gathered whole over both halves); the
    fsdp block counts the leaves by the halves that cut them. The keys
    are the reference's, each layer's leaves stacked."""
    from repro_torch import bridge, pytree
    from repro_torch.launch import train
    res = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--ranks", "4", "--model-parallel", "2", "--steps",
                      "1", "--seq", "32", "--batch", "8", "--ckpt",
                      str(tmp_path)], keep_params=True, parallel=FSDP)
    tag = {"qwen2.5-3b": "qwen", "olmoe-1b-7b": "olmoe"}[arch]
    assert res["fsdp"]["leaves"] == KINDS[tag]
    assert res["layout"] == ("fsdp+ep" if tag == "olmoe" else "fsdp+tp")
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    shapes = {r["key"]: r["shape"] for r in manifest["leaves"]}
    d = 256
    assert shapes["params/embed/tok"] == [1024, d]
    assert shapes["params/embed/out"] == [d, 1024]
    if tag == "olmoe":
        assert shapes["params/layers/moe/w_gate"] == [2, 4, d, 512]
        assert shapes["opt/.mu/layers/moe/w_down"] == [2, 4, 512, d]
    else:
        assert shapes["params/layers/attn/wq"] == [2, d, 4, 64]
        assert shapes["opt/.mu/layers/mlp/w_up"] == [2, d, 512]
    arrays = np.load(tmp_path / "arrays.npz")
    n = 0
    for _, key, layer, whole in bridge.reference_leaves(res["params"]):
        written = arrays[f"params__{key.replace('/', '__')}"]
        if layer is not None:
            written = written[layer]
        np.testing.assert_array_equal(written, whole.numpy(), err_msg=key)
        n += 1
    assert n == sum(KINDS[tag].values())
    # a rank holds a quarter of each leaf cut by both halves
    assert res["param_elems"] < sum(
        t.numel() for t in pytree.leaves(res["params"]))
