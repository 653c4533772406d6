"""The port's tensor parallelism in training against the JAX package's.

The reference runs in one subprocess with
``--xla_force_host_platform_device_count=4`` on a ``("data", "model")``
2x2 mesh, its params placed by ``param_specs`` (Megatron-style over
``model``) and computed at fp32; the port in one spawned 4-rank
``gloo`` group on the same mesh, the params carried across by
``repro_torch.bridge`` and each rank keeping its `sharding.tp_shard`
slice. Every rank holds its data coordinate's rows of the global batch
(8 x 32). This file holds the reduced smollm-135m: 4 query heads over
2 ranks and 1 kv head, the mixed layout (``wk``/``wv`` replicated, each
rank reading the kv head of its query heads);
``tests/test_torch_tp_families.py`` the other families.

- Loss and gradients at fp32: each rank's gradients (after
  `steps.tp_correct`, averaged over ``data``) within 1e-3 of each
  leaf's scale against its slice of the reference's, the loss within
  1e-5.
- One training step, untuned, tuned (``--collective ring`` and
  ``tuned_decision.json``) and overlapped, against the reference's
  untuned ``build_train_step`` on the same mesh (fp32 compute,
  ``warmup_steps=0``): losses within 1e-2, each leaf's change within
  1e-2 (relative 2-norm), the step's synced gradients within 1e-3 and
  the overlapped step's (on the sync thread) equal to the plain tuned
  step's and to the same step synced inside the backward within 1e-6;
  replicated leaves bit-equal on every rank, each slice on both data
  ranks that hold it.
- Each fault of `steps.planted_tp_fault`, planted in the tuned step,
  reads above the gradient tolerance.
- The collectives of one forward and backward over ``model``, counted:
  the per-chunk loss's recompute issues its reductions again.
- A ``(1 data, 2 model)`` step against a one-rank step of the port.
- ``--ckpt`` under a ``model`` axis writes whole leaves, which
  `sharding.tp_shard` cuts back to the held slices.
"""
import contextlib
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.core.collectives import group as grp  # noqa: E402
from repro_torch.launch.steps import TP_FAULTS  # noqa: E402

HERE = os.path.dirname(__file__)
ROOT = os.path.join(HERE, "..")
FLAT = os.path.join(ROOT, "examples", "artifacts", "tuned_decision.json")
STEPS = ("untuned", "ring", "tuned", "overlapped")
#: the overlapped step with each layer synced inside the backward
IN_BACKWARD = "in_backward"
GRAD_TOL = 1e-3          # |got - want| / max|want|, a leaf
LOSS_TOL = 1e-5
STEP_LOSS_TOL = 1e-2
STEP_CHANGE_TOL = 1e-2   # |d_got - d_want| / |d_want| (2-norms), a leaf
OVERLAP_TOL = 1e-6       # overlapped against plain, the same tuned sync
SEQ, BATCH = 32, 8
ARCH = "smollm-135m"

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

mesh = compat.make_mesh((2, 2), ("data", "model"))
shape = ShapeConfig(name="tp", seq_len=cfg_in["seq"],
                    global_batch=cfg_in["batch"], kind="train")
out = {}
for arch in cfg_in["archs"]:
    cfg = get_config(arch).reduced()
    batch = make_train_batch(cfg, shape, seed=7)
    params = build_model(cfg, attn_impl="xla").init(jax.random.PRNGKey(2))
    out.update({f"{arch}|params|{k}": v for k, v in flat(params).items()})
    out.update({f"{arch}|batch|{k}": np.asarray(v, np.float32)
                if jnp.issubdtype(v.dtype, jnp.floating) else np.asarray(v)
                for k, v in batch.items()})      # numpy has no bfloat16
    sh.set_current_mesh(mesh)
    pspecs = sh.param_specs(jax.eval_shape(lambda: params), cfg,
                            ParallelConfig(), mesh)
    placed = jax.device_put(params, sh.to_named(pspecs, mesh))
    api = build_model(cfg, compute_dtype=jnp.float32, attn_impl="xla",
                      ssd_impl="xla")
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, b: api.loss(p, b)[0]))(placed, batch)
    out[f"{arch}|loss"] = np.asarray(loss)
    out.update({f"{arch}|grad|{k}": v for k, v in flat(g).items()})
    if arch == cfg_in.get("step"):
        # the step builds its model in the default (bf16) compute dtype,
        # whatever ParallelConfig says: here it computes in fp32
        rsteps.build_model = lambda c, **kw: build_model(
            c, compute_dtype=jnp.float32, **kw)
        fn, _, in_sh, out_sh, _ = build_train_step(
            cfg, shape, ParallelConfig(compute_dtype="float32"),
            CollectiveConfig(), mesh, warmup_steps=0)
        rsteps.build_model = build_model
        opt = jax.device_put(AdamW(lr=3e-4).init(params), in_sh[1])
        new_p, _, m = jax.jit(fn, in_shardings=in_sh,
                              out_shardings=out_sh)(placed, opt, batch)
        out[f"{arch}|step|loss"] = np.asarray(m["loss"])
        out.update({f"{arch}|step|params|{k}": v
                    for k, v in flat(jax.device_get(new_p)).items()})
    sh.set_current_mesh(None)
np.savez(cfg_in["out"], **out)
print("ok")
"""


def nest(flat: dict) -> dict:
    """'a/b/c' -> nested dicts."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def port_flat(tree) -> dict:
    """A port tree (per-layer list) as the reference's stacked layout,
    flattened to 'a/b/c' keys."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}{k}/")
        else:
            out[prefix[:-1]] = np.asarray(t, np.float32)
    walk(bridge.to_reference(tree), "")
    return out


def ref_slice(key: str, arr, m: int, tp: int = 2):
    """The reference's leaf ``key`` (its stacked layout) as model rank
    ``m``'s `sharding.tp_shard` slice: `tp_dim` of the per-layer leaf,
    one dimension higher under a stacked key."""
    from repro_torch.parallel import sharding as sh
    path = tuple(key.split("/"))
    off = 1 if path[0] in bridge.STACKED else 0
    d = sh.tp_dim(path, arr.shape[off:], tp)
    if d is None:
        return arr
    n = arr.shape[d + off] // tp
    return np.take(arr, range(m * n, (m + 1) * n), axis=d + off)


def inputs(ref, arch, rows):
    """The reference's params (full, the port's layout) and this rank's
    rows of its batch."""
    params = bridge.from_jax(nest({k.split("|", 2)[2]: v
                                   for k, v in ref.items()
                                   if k.startswith(f"{arch}|params|")}))
    batch = bridge.batch_from_jax(
        {k.split("|", 2)[2]: v for k, v in ref.items()
         if k.startswith(f"{arch}|batch|")})
    return params, {k: v[rows] for k, v in batch.items()}


def value_and_grad(api, params, batch):
    from repro_torch import pytree
    leaves, treedef = pytree.flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    loss, _ = api.loss(treedef.unflatten(leaves), batch)
    return loss.detach(), treedef.unflatten(
        list(torch.autograd.grad(loss, leaves)))


def loss_and_grads(ref, mesh, out, archs):
    """Every rank's loss and corrected gradients of each arch, averaged
    over ``data``, into ``out`` (``{arch}|loss``, ``{arch}|grad|...``);
    the collectives of smollm's forward and backward over ``model``
    counted into ``out["collectives"]`` (psum, pmax)."""
    from repro_torch import pytree
    from repro_torch.configs import ARCHITECTURES
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding as sh
    data_ax = mesh.axis("data")
    rows = sh.batch_rows(mesh, BATCH)

    def dmean(x):
        return grp.psum(x, data_ax) / mesh.shape["data"]

    calls = {"psum": 0, "pmax": 0}

    def counted(name):
        fn = getattr(grp, name)

        def wrapped(x, group=None):
            if group is mesh.axis("model"):
                calls[name] += 1
            return fn(x, group)
        return fn, wrapped
    for arch in archs:
        cfg = ARCHITECTURES[arch].reduced()
        full, batch = inputs(ref, arch, rows)
        params = sh.tp_shard(full, mesh)
        api = build_model(cfg, compute_dtype=torch.float32, device="cpu",
                          tp_axis="model", mesh=mesh)
        saved = {n: counted(n) for n in calls}
        if arch == ARCH:
            for n, (_, w) in saved.items():
                setattr(grp, n, w)
        try:
            loss, g = value_and_grad(api, params, batch)
        finally:
            for n, (f, _) in saved.items():
                setattr(grp, n, f)
        g = steps.tp_correct(g, mesh, cfg)
        out[f"{arch}|loss"] = dmean(loss).numpy()
        for k, v in port_flat(pytree.tree_map(dmean, g)).items():
            out[f"{arch}|grad|{k}"] = v
    out["collectives"] = np.asarray([calls["psum"], calls["pmax"]])


# ---------------------------------------------------------------------------
# the port's groups
# ---------------------------------------------------------------------------
def _rank_work(ref_path, out_dir):
    from repro_torch import pytree
    from repro_torch.comms import Communicator
    from repro_torch.configs import ARCHITECTURES, ParallelConfig, \
        ShapeConfig
    from repro_torch.configs.base import CollectiveConfig
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding as sh

    ref = dict(np.load(ref_path))
    mesh = make_local_mesh(2, device="cpu")
    out = {"model": np.asarray(grp.rank(mesh.axis("model"))),
           "data": np.asarray(grp.rank(mesh.axis("data")))}
    loss_and_grads(ref, mesh, out, (ARCH,))

    # one training step at fp32: untuned, tuned (ring, the table),
    # overlapped, and the table's step with each planted fault
    cfg = ARCHITECTURES[ARCH].reduced()
    shape = ShapeConfig(name="tp", seq_len=SEQ, global_batch=BATCH,
                        kind="train")
    full, batch = inputs(ref, ARCH, sh.batch_rows(mesh, BATCH))
    params = sh.tp_shard(full, mesh)
    for name in (*STEPS, IN_BACKWARD, *TP_FAULTS):
        coll = {"untuned": CollectiveConfig(),
                "ring": CollectiveConfig(algorithm="ring"),
                "overlapped": CollectiveConfig(decision=FLAT,
                                               overlap_backward=True),
                IN_BACKWARD: CollectiveConfig(decision=FLAT,
                                              overlap_backward=True)
                }.get(name, CollectiveConfig(decision=FLAT))
        comm = Communicator.create(
            mesh, artifact=coll.decision,
            algorithm=coll.algorithm if name == "ring" else "xla")
        if name == IN_BACKWARD:     # the sink's synchronous form, no thread
            sink = comm.release_sink
            comm.release_sink = lambda *a, _s=sink, **k: _s(
                *a, **{**k, "overlap": False})
        step = steps.build_train_step(
            cfg, shape, ParallelConfig(compute_dtype="float32"), coll, mesh,
            communicator=comm, warmup_steps=0, device="cpu")
        assert step.tuned == (name != "untuned") and step.tp_axis == "model"
        p = pytree.tree_map(torch.clone, params)    # updated in place
        plant = steps.planted_tp_fault(name) if name in TP_FAULTS \
            else contextlib.nullcontext()
        with plant:
            new_p, _, m = step.fn(p, step.opt.init(p), batch,
                                  keep_grads=True)
        out[f"step_{name}|loss"] = np.asarray(float(m["loss"]))
        out[f"step_{name}|release_sync_s"] = np.asarray(
            m.get("release_sync_s", 0.0))
        out[f"step_{name}|replicas"] = np.asarray(train._replicas(new_p,
                                                                  step))
        for k, v in port_flat(new_p).items():
            out[f"step_{name}|params|{k}"] = v
        for k, v in port_flat(m["grads"]).items():
            out[f"step_{name}|grad|{k}"] = v
    np.savez(os.path.join(out_dir, f"r{grp.rank()}.npz"), **out)


def _small_step(ref_path, model_parallel):
    """One untuned step over the whole batch on a ``(1 data,
    model_parallel model)`` mesh: rank 0's loss, and its synced
    gradients and new params gathered whole."""
    from repro_torch.configs import ARCHITECTURES, ParallelConfig, \
        ShapeConfig
    from repro_torch.configs.base import CollectiveConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding as sh

    ref = dict(np.load(ref_path))
    mesh = make_local_mesh(model_parallel, device="cpu")
    cfg = ARCHITECTURES[ARCH].reduced()
    shape = ShapeConfig(name="tp", seq_len=SEQ, global_batch=BATCH,
                        kind="train")
    step = steps.build_train_step(
        cfg, shape, ParallelConfig(compute_dtype="float32"),
        CollectiveConfig(), mesh, warmup_steps=0, device="cpu")
    full, batch = inputs(ref, ARCH, step.rows)
    params = full if step.tp_axis is None else sh.tp_shard(full, mesh)
    new_p, _, m = step.fn(params, step.opt.init(params), batch,
                          keep_grads=True)
    return {"loss": float(m["loss"]),
            "grads": port_flat(step.gather(m["grads"])),
            "params": port_flat(step.gather(new_p))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    cfg = {"seq": SEQ, "batch": BATCH, "archs": [ARCH], "step": ARCH,
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
    grp.spawn(_rank_work, 4, (cfg["out"], str(tmp)), timeout_s=300)
    return types.SimpleNamespace(
        ref=dict(np.load(cfg["out"])), ref_path=cfg["out"],
        port=[dict(np.load(tmp / f"r{r}.npz")) for r in range(4)])


def _grad_readings(run, port_prefix, ref_prefix):
    """max over ranks of |got - want| / max|want|, per leaf, each rank
    against its slice of the reference's leaf."""
    read = {}
    for port in run.port:
        m = int(port["model"])
        keys = [k for k in port if k.startswith(port_prefix + "|")]
        assert keys
        for k in keys:
            leaf = k[len(port_prefix) + 1:]
            want = ref_slice(leaf, run.ref[f"{ref_prefix}|{leaf}"], m)
            got = port[k]
            assert got.shape == want.shape, (k, got.shape, want.shape)
            scale = float(np.abs(want).max()) or 1.0
            read[leaf] = max(read.get(leaf, 0.0),
                             float(np.abs(got - want).max()) / scale)
    return read


def test_loss_and_grads_match_reference_mixed_heads(run):
    for port in run.port:
        np.testing.assert_allclose(port[f"{ARCH}|loss"],
                                   run.ref[f"{ARCH}|loss"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    read = _grad_readings(run, f"{ARCH}|grad", f"{ARCH}|grad")
    worst = max(read, key=read.get)
    assert read[worst] <= GRAD_TOL, (worst, read[worst])
    # the mixed layout: query heads split, the one kv head whole
    port = run.port[0]
    assert port[f"{ARCH}|grad|layers/attn/wq"].shape[2] == 2
    assert port[f"{ARCH}|grad|layers/attn/wk"].shape[2] == 1
    assert port[f"{ARCH}|grad|layers/mlp/w_up"].shape[2] == 256
    assert port[f"{ARCH}|grad|embed/tok"].shape[0] == 512


def test_the_model_axis_collectives_of_one_forward_and_backward(run):
    """Reduced smollm (2 layers, one 32-row chunk of the loss): every
    column-parallel product enters through its own copy_to_model (one
    psum backward: the attention's q, k and v, the MLP's gate and up,
    the loss's logits) and every row-parallel one leaves through
    reduce_from_model (one psum forward: the attention's output, the
    MLP's down), the embedding through one; the loss's chunk takes the
    row max (pmax) and two psums (the sum of exps, the picked logit) in
    the forward and again in its recompute."""
    layers, chunks = 2, 1
    per_layer = (3 + 1) + (2 + 1)
    want = [layers * per_layer + 1 + chunks * (1 + 2 * 2), chunks * 2]
    for port in run.port:
        assert port["collectives"].tolist() == want


def _change_readings(run, variant):
    """max over ranks of |d_got - d_want| / |d_want| (2-norms) per leaf,
    d the change of the params over the step from the initial ones."""
    read = {}
    for port in run.port:
        m = int(port["model"])
        keys = [k for k in port if k.startswith(f"step_{variant}|params|")]
        assert keys
        for k in keys:
            leaf = k.split("|", 2)[2]
            init = ref_slice(leaf, run.ref[f"{ARCH}|params|{leaf}"], m)
            want = ref_slice(leaf, run.ref[f"{ARCH}|step|params|{leaf}"],
                             m).astype(np.float64) - init
            got = port[k].astype(np.float64) - init
            den = np.linalg.norm(want)
            assert den > 0, leaf
            read[leaf] = max(read.get(leaf, 0.0),
                             float(np.linalg.norm(got - want) / den))
    return read


@pytest.mark.parametrize("variant", STEPS)
def test_one_train_step_matches_the_reference(run, variant):
    ref_loss = float(run.ref[f"{ARCH}|step|loss"])
    for port in run.port:
        assert abs(float(port[f"step_{variant}|loss"]) - ref_loss) < \
            STEP_LOSS_TOL
        assert bool(port[f"step_{variant}|replicas"])
    read = _change_readings(run, variant)
    worst = max(read, key=read.get)
    assert read[worst] <= STEP_CHANGE_TOL, (worst, read[worst])
    read = _grad_readings(run, f"step_{variant}|grad", f"{ARCH}|grad")
    worst = max(read, key=read.get)
    assert read[worst] <= GRAD_TOL, (worst, read[worst])


def test_overlapped_step_equals_the_plain_tuned_step(run):
    for port in run.port:
        for key in [k for k in port if k.startswith("step_tuned|grad|")]:
            got = port[key.replace("step_tuned", "step_overlapped", 1)]
            want = port[key]
            scale = float(np.abs(want).max()) or 1.0
            assert float(np.abs(got - want).max()) <= OVERLAP_TOL * scale, \
                key
        assert port["step_overlapped|loss"] == port["step_tuned|loss"]


def test_overlapped_step_equals_the_in_backward_step(run):
    """The overlapped step syncs each layer on the sync thread (its busy
    seconds above 0) while the backward's model-axis all-reduces run on
    the main thread, and gives the gradients and loss of the same step
    with each layer synced inside the backward, within
    ``OVERLAP_TOL``."""
    for port in run.port:
        assert float(port["step_overlapped|release_sync_s"]) > 0.0
        assert float(port[f"step_{IN_BACKWARD}|release_sync_s"]) == 0.0
        for key in [k for k in port
                    if k.startswith(f"step_{IN_BACKWARD}|grad|")]:
            got = port[key.replace(IN_BACKWARD, "overlapped", 1)]
            want = port[key]
            scale = float(np.abs(want).max()) or 1.0
            assert float(np.abs(got - want).max()) <= OVERLAP_TOL * scale, \
                key
        assert abs(float(port["step_overlapped|loss"])
                   - float(port[f"step_{IN_BACKWARD}|loss"])) <= OVERLAP_TOL


def test_replicated_leaves_bit_equal_across_model(run):
    """After the tuned step, every leaf the layout keeps whole (the
    norms, the mixed layout's wk/wv) is the same bits on all four
    ranks; each slice on the two data ranks that hold it."""
    from repro_torch.parallel import sharding as sh
    keys = [k for k in run.port[0] if k.startswith("step_tuned|params|")]
    whole = 0
    for k in keys:
        leaf = tuple(k.split("|", 2)[2].split("/"))
        off = 1 if leaf[0] in bridge.STACKED else 0
        shape = run.ref[f"{ARCH}|params|{'/'.join(leaf)}"].shape[off:]
        split = sh.tp_dim(leaf, shape, 2) is not None
        whole += not split
        for a in run.port:
            for b in run.port:
                if not split or a["model"] == b["model"]:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert whole >= 5      # final_norm, ln1, ln2, wk, wv


@pytest.mark.parametrize("fault", TP_FAULTS)
def test_each_planted_fault_fails_the_grad_check(run, fault):
    read = _grad_readings(run, f"step_{fault}|grad", f"{ARCH}|grad")
    assert max(read.values()) > GRAD_TOL, read


def test_one_by_two_mesh_step_equals_the_one_rank_step(run):
    """The whole batch on ``(1 data, 2 model)`` against one rank without
    a model axis: the same loss, synced gradients and params' change,
    up to the order of the split sums."""
    tp = grp.spawn(_small_step, 2, (run.ref_path, 2), timeout_s=300)
    one = grp.spawn(_small_step, 1, (run.ref_path, 1), timeout_s=300)
    assert abs(tp["loss"] - one["loss"]) <= LOSS_TOL
    assert sorted(tp["grads"]) == sorted(one["grads"])
    for k, want in one["grads"].items():
        scale = float(np.abs(want).max()) or 1.0
        assert float(np.abs(tp["grads"][k] - want).max()) <= \
            LOSS_TOL * scale, k
    init = {k.split("|", 2)[2]: v for k, v in run.ref.items()
            if k.startswith(f"{ARCH}|params|")}
    for k, want in one["params"].items():
        d_want = want.astype(np.float64) - init[k]
        d_got = tp["params"][k].astype(np.float64) - init[k]
        assert np.linalg.norm(d_got - d_want) <= \
            STEP_CHANGE_TOL * np.linalg.norm(d_want), k


def test_checkpoint_writes_whole_leaves(tmp_path):
    """``--ckpt`` under a ``model`` axis: rank 0 writes the reference's
    whole leaves (params and Adam's moments) under the reference's keys,
    stacked over the layers; cut as `sharding.tp_shard` cuts them, rank
    0's are its held slices."""
    from repro_torch import bridge
    from repro_torch.launch import train
    from repro_torch.parallel import sharding as sh
    res = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--ranks", "4", "--model-parallel", "2", "--steps",
                      "1", "--seq", "32", "--batch", "8", "--ckpt",
                      str(tmp_path)], keep_params=True)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    shapes = {r["key"]: r["shape"] for r in manifest["leaves"]}
    d = 256
    assert shapes["params/embed/tok"] == [1024, d]
    assert shapes["params/embed/out"] == [d, 1024]
    assert shapes["params/layers/attn/wq"] == [2, d, 4, 64]
    assert shapes["params/layers/attn/wo"] == [2, 4, 64, d]
    assert shapes["params/layers/mlp/w_down"] == [2, 512, d]
    assert shapes["opt/.mu/layers/mlp/w_up"] == [2, d, 512]     # Adam's mu
    arrays = np.load(tmp_path / "arrays.npz")
    cut = 0
    for path, key, layer, held in bridge.reference_leaves(res["params"]):
        whole = arrays[f"params__{key.replace('/', '__')}"]
        if layer is not None:
            whole = whole[layer]
        dim = sh.tp_dim(path, whole.shape, 2)
        if dim is not None:
            whole = np.take(whole, range(held.shape[dim]), axis=dim)
            cut += 1
        np.testing.assert_array_equal(whole, held.numpy(), err_msg=key)
    assert cut == 2 + 2 * (2 + 3)      # tok, out; wq, wo, the MLP's three
