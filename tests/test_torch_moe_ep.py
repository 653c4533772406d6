"""The port's MoE expert parallelism against the JAX package's.

The reference runs in one subprocess with
``--xla_force_host_platform_device_count=4`` on a ``("data", "model")``
2x2 mesh; the port in one spawned 4-rank ``gloo`` group on the same
mesh, the reduced olmoe-1b-7b's params carried across by
``repro_torch.bridge`` and each rank keeping its expert slice
(`sharding.ep_shard`). Every rank holds its data coordinate's rows of
the global batch (8 x 32) and routes its ``S/tp`` sequence chunk.

- The EP loss and gradients at fp32 against the reference's EP path
  (its nested ``shard_map`` under XLA's partitioning), for the dispatch
  all-to-all ``"xla"``, ``pairwise``, ``bruck`` and a `Communicator`
  over ``tuned_decision.json``: each rank's gradients (corrected for
  the replica factor, averaged over ``data``) within 1e-3 of each
  leaf's scale (its expert slice of the reference's), the
  cross-entropy and aux losses within 1e-5 (see `_check_losses`); the
  Communicator's run equals the directly named algorithm's bit for
  bit.
- The EP loss against the single-device path at ``capacity_factor=4.0``
  (no token dropped on either side) within 5e-3, as
  ``tests/helpers/validate_distributed.py`` section 2 holds the
  reference.
- One training step, untuned, tuned (the table) and overlapped
  (``--overlap-backward``), against the reference's untuned
  ``build_train_step`` on the same mesh (fp32 compute, so that Adam's
  update can be held leaf by leaf; ``warmup_steps=0``): losses within
  1e-2; each leaf's change of the params (new - initial) within 1e-2 of
  the reference's (relative 2-norm), so a lost or reversed update reads
  1 or 2; non-expert params equal on every rank, each expert slice on
  both data ranks that hold it.
- AdamW's first step is nearly scale-invariant in the gradient, so each
  step's synced gradients (``fn(..., keep_grads=True)``, what its update
  reads) are held too: within 1e-3 of each leaf's scale against the
  reference's nested path, and their clip norm (`steps.ep_global_norm`)
  against the norm of the reference's whole tree. Each fault of
  `steps.planted_ep_fault` (expert gradients left undivided by tp,
  replicated gradients not averaged over ``model``, the reverse
  exchange replaced by identity), planted in the tuned step, reads
  above that tolerance on some leaf
  (``tests/helpers/validate_communicator.py`` section 7's reasoning).
- ``--ckpt`` under the ``model`` axis writes every expert.
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
from repro_torch.launch.steps import EP_FAULTS  # noqa: E402

HERE = os.path.dirname(__file__)
ROOT = os.path.join(HERE, "..")
FLAT = os.path.join(ROOT, "examples", "artifacts", "tuned_decision.json")
ALGOS = ("xla", "pairwise", "bruck", "comm")
STEPS = ("untuned", "tuned", "overlapped")
FAULTS = EP_FAULTS
GRAD_TOL = 1e-3          # |got - want| / max|want|, a leaf
LOSS_TOL = 1e-5
SINGLE_TOL = 5e-3
STEP_LOSS_TOL = 1e-2
STEP_CHANGE_TOL = 1e-2   # |d_got - d_want| / |d_want| (2-norms), a leaf
SEQ, BATCH = 32, 8

REF_SCRIPT = r"""
import json, os, sys
cfg_in = json.load(open(sys.argv[1]))
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from repro import compat
from repro.comms import Communicator
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
shape = ShapeConfig(name="ep", seq_len=cfg_in["seq"],
                    global_batch=cfg_in["batch"], kind="train")
out = {}
for tag, cf, ne in (("", None, None), ("cf4_", 4.0, 8)):
    cfg = get_config("olmoe-1b-7b").reduced()
    if cf:
        cfg = cfg.replace(num_experts=ne, capacity_factor=cf)
    batch = make_train_batch(cfg, shape, seed=7)
    params = build_model(cfg, attn_impl="xla").init(jax.random.PRNGKey(2))
    out.update({f"{tag}params|{k}": v for k, v in flat(params).items()})
    out.update({f"{tag}batch|{k}": np.asarray(v) for k, v in batch.items()})
    sh.set_current_mesh(None)
    single = build_model(cfg, compute_dtype=jnp.float32, attn_impl="xla")
    out[f"{tag}single_loss"] = np.asarray(
        jax.jit(single.loss)(params, batch)[0])
    sh.set_current_mesh(mesh)
    pspecs = sh.param_specs(jax.eval_shape(lambda: params), cfg,
                            ParallelConfig(), mesh)
    params_ep = jax.device_put(params, sh.to_named(pspecs, mesh))
    algos = ("xla",) if cf else ("xla", "pairwise", "bruck", "comm")
    for name in algos:
        algo = Communicator.create(mesh, artifact=cfg_in["flat"]) \
            if name == "comm" else name
        api = build_model(cfg, ep_axis="model", mesh=mesh,
                          compute_dtype=jnp.float32, attn_impl="xla",
                          a2a_algorithm=algo)
        (loss, aux), g = jax.jit(jax.value_and_grad(api.loss,
                                                    has_aux=True))(
            params_ep, batch)
        out[f"{tag}{name}|loss"] = np.asarray(loss)
        for k, v in aux.items():
            out[f"{tag}{name}|{k}"] = np.asarray(v)
        out.update({f"{tag}{name}|grad|{k}": v
                    for k, v in flat(g).items()})
    if not cf:
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
                              out_shardings=out_sh)(params_ep, opt, batch)
        out["step|loss"] = np.asarray(m["loss"])
        out.update({f"step|params|{k}": v
                    for k, v in flat(jax.device_get(new_p)).items()})
    sh.set_current_mesh(None)
np.savez(cfg_in["out"], **out)
print("ok")
"""


def _nest(flat: dict) -> dict:
    """'a/b/c' -> nested dicts."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _port_flat(tree) -> dict:
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


def _is_expert(key: str) -> bool:
    parts = key.split("/")
    return len(parts) >= 2 and parts[-2] == "moe" and \
        parts[-1] in ("w_gate", "w_up", "w_down")


# ---------------------------------------------------------------------------
# the port's group
# ---------------------------------------------------------------------------
def _rank_work(ref_path, out_dir):
    from repro_torch import pytree
    from repro_torch.comms import Communicator
    from repro_torch.configs import ARCHITECTURES, ParallelConfig, \
        ShapeConfig
    from repro_torch.configs.base import CollectiveConfig
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding as sh

    ref = dict(np.load(ref_path))
    mesh = make_local_mesh(2, device="cpu")
    data_ax = mesh.axis("data")
    shape = ShapeConfig(name="ep", seq_len=SEQ, global_batch=BATCH,
                        kind="train")
    rows = sh.batch_rows(mesh, BATCH)
    lo, hi = sh.expert_range(mesh, 4)
    out = {"experts": np.asarray([lo, hi]),
           "data": np.asarray(grp.rank(data_ax))}
    fp32 = ParallelConfig(compute_dtype="float32")

    def inputs(tag):
        params = bridge.from_jax(_nest({k.split("|", 1)[1]: v
                                        for k, v in ref.items()
                                        if k.startswith(f"{tag}params|")}))
        batch = bridge.batch_from_jax(
            {k.split("|", 1)[1]: v for k, v in ref.items()
             if k.startswith(f"{tag}batch|")})
        return params, {k: v[rows] for k, v in batch.items()}

    def dmean(x):
        return grp.psum(x, data_ax) / mesh.shape["data"]

    def save(prefix, tree):
        for k, v in _port_flat(tree).items():
            out[f"{prefix}|{k}"] = v

    def value_and_grad(api, params, batch):
        leaves, treedef = pytree.flatten(params)
        leaves = [t.detach().requires_grad_() for t in leaves]
        loss, aux = api.loss(treedef.unflatten(leaves), batch)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
            treedef.unflatten(list(torch.autograd.grad(loss, leaves)))

    # the EP path, each dispatch algorithm, fp32
    for tag, cfg in (("", ARCHITECTURES["olmoe-1b-7b"].reduced()),
                     ("cf4_", ARCHITECTURES["olmoe-1b-7b"].reduced()
                      .replace(num_experts=8, capacity_factor=4.0))):
        full, batch = inputs(tag)
        params = sh.ep_shard(full, mesh)
        for name in (ALGOS if not tag else ("xla",)):
            algo = Communicator.create(mesh, artifact=FLAT) \
                if name == "comm" else name
            api = build_model(cfg, compute_dtype=torch.float32,
                              device="cpu", ep_axis="model", mesh=mesh,
                              a2a_algorithm=algo)
            loss, aux, g = value_and_grad(api, params, batch)
            out[f"{tag}{name}|loss"] = dmean(loss).numpy()
            out[f"{tag}{name}|ce"] = dmean(aux["ce"]).numpy()
            for k in ("lb_loss", "z_loss"):      # averaged over model only
                out[f"{tag}{name}|{k}"] = aux[k].numpy()
            save(f"{tag}{name}|grad", pytree.tree_map(
                dmean, steps.ep_correct(g, mesh)))

    # one training step at fp32: untuned, tuned, overlapped, and the
    # tuned step with each planted fault
    cfg = ARCHITECTURES["olmoe-1b-7b"].reduced()
    full, batch = inputs("")
    params = sh.ep_shard(full, mesh)
    for name in (*STEPS, *FAULTS):
        coll = CollectiveConfig() if name == "untuned" else \
            CollectiveConfig(decision=FLAT,
                             overlap_backward=name == "overlapped")
        comm = Communicator.create(
            mesh, artifact=None if name == "untuned" else FLAT)
        step = steps.build_train_step(cfg, shape, fp32, coll, mesh,
                                      communicator=comm, warmup_steps=0,
                                      device="cpu")
        assert step.tuned == (name != "untuned")
        p = pytree.tree_map(torch.clone, params)    # updated in place
        plant = steps.planted_ep_fault(name) if name in FAULTS \
            else contextlib.nullcontext()
        with plant:
            new_p, _, m = step.fn(p, step.opt.init(p), batch,
                                  keep_grads=True)
        out[f"step_{name}|loss"] = np.asarray(float(m["loss"]))
        out[f"step_{name}|gnorm"] = np.asarray(
            float(steps.ep_global_norm(m["grads"], mesh)))
        out[f"step_{name}|replicas"] = np.asarray(
            train._replicas(new_p, step))
        save(f"step_{name}|params", new_p)
        save(f"step_{name}|grad", m["grads"])
    np.savez(os.path.join(out_dir, f"r{grp.rank()}.npz"), **out)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    cfg = {"seq": SEQ, "batch": BATCH, "flat": FLAT,
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
    # the ranks read the reference's params and batch
    grp.spawn(_rank_work, 4, (cfg["out"], str(tmp)), timeout_s=300)
    return types.SimpleNamespace(
        ref=dict(np.load(cfg["out"])),
        port=[dict(np.load(tmp / f"r{r}.npz")) for r in range(4)])


def _want(ref, key, experts):
    """The reference's leaf ``key`` as rank ``experts``' slice."""
    w = ref[key]
    if _is_expert(key):
        lo, hi = experts
        w = w[:, lo:hi]
    return w


def _grad_readings(run, port_prefix, ref_prefix):
    """max over ranks of |got - want| / max|want|, per leaf."""
    read = {}
    for r, port in enumerate(run.port):
        keys = [k for k in port if k.startswith(port_prefix + "|")]
        assert keys
        for k in keys:
            leaf = k[len(port_prefix) + 1:]
            want = _want(run.ref, f"{ref_prefix}|{leaf}", port["experts"])
            got = port[k]
            assert got.shape == want.shape, (k, got.shape, want.shape)
            scale = float(np.abs(want).max()) or 1.0
            read[leaf] = max(read.get(leaf, 0.0),
                             float(np.abs(got - want).max()) / scale)
    return read


def _check_losses(run, prefix):
    """The cross-entropy (averaged over the data ranks) and the aux
    losses against the reference's. The reference's nested path returns
    its aux losses with ``out_specs=P()`` and ``check_vma=False``, so
    their value is data rank 0's (its gradients are those of the mean
    over the data ranks, as the port's): data rank 0's aux losses are
    held to them."""
    for port in run.port:
        np.testing.assert_allclose(port[f"{prefix}|ce"],
                                   run.ref[f"{prefix}|ce"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        if int(port["data"]) == 0:
            for k in ("lb_loss", "z_loss"):
                np.testing.assert_allclose(port[f"{prefix}|{k}"],
                                           run.ref[f"{prefix}|{k}"],
                                           rtol=LOSS_TOL, atol=LOSS_TOL)


@pytest.mark.parametrize("algo", ALGOS)
def test_ep_loss_and_grads_match_reference(run, algo):
    _check_losses(run, algo)
    read = _grad_readings(run, f"{algo}|grad", f"{algo}|grad")
    worst = max(read, key=read.get)
    assert read[worst] <= GRAD_TOL, (worst, read[worst])
    # every rank holds its own experts: [0, 2) on model rank 0
    assert [p["experts"].tolist() for p in run.port] == \
        [[0, 2], [2, 4], [0, 2], [2, 4]]


def test_communicator_equals_the_named_algorithm_bit_for_bit(run):
    from repro_torch.comms import Communicator
    from repro_torch.configs import ARCHITECTURES
    from repro_torch.models import moe
    # the table resolves this dispatch buffer ((E, C, d) fp32, C from a
    # rank's 4 rows x 16 tokens) to one of the survey's all-to-alls
    cfg = ARCHITECTURES["olmoe-1b-7b"].reduced()
    nbytes = cfg.num_experts * moe.capacity(cfg, 4 * SEQ // 2) * \
        cfg.d_model * 4
    name = Communicator.create(artifact=FLAT).a2a_algorithm_for(
        nbytes, "model", 2)
    assert name in ("pairwise", "bruck"), name
    for port in run.port:
        keys = [k for k in port if k.startswith("comm|")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                port[k], port[k.replace("comm|", f"{name}|", 1)], err_msg=k)


def test_ep_loss_matches_the_single_device_path_at_high_capacity(run):
    single = float(run.ref["cf4_single_loss"])
    for port in run.port:
        assert abs(float(port["cf4_xla|loss"]) - single) < SINGLE_TOL
    _check_losses(run, "cf4_xla")


def _change_readings(run, variant):
    """max over ranks of |d_got - d_want| / |d_want| (2-norms) per leaf,
    d the change of the params over the step from the initial ones."""
    read = {}
    for port in run.port:
        keys = [k for k in port if k.startswith(f"step_{variant}|params|")]
        assert keys
        for k in keys:
            leaf = k.split("|", 2)[2]
            init = _want(run.ref, f"params|{leaf}", port["experts"])
            want = _want(run.ref, f"step|params|{leaf}",
                         port["experts"]).astype(np.float64) - init
            got = port[k].astype(np.float64) - init
            den = np.linalg.norm(want)
            assert den > 0, leaf
            read[leaf] = max(read.get(leaf, 0.0),
                             float(np.linalg.norm(got - want) / den))
    return read


@pytest.mark.parametrize("variant", STEPS)
def test_one_train_step_matches_the_reference(run, variant):
    ref_loss = float(run.ref["step|loss"])
    for port in run.port:
        assert abs(float(port[f"step_{variant}|loss"]) - ref_loss) < \
            STEP_LOSS_TOL
        assert bool(port[f"step_{variant}|replicas"])
    read = _change_readings(run, variant)
    worst = max(read, key=read.get)
    assert read[worst] <= STEP_CHANGE_TOL, (worst, read[worst])


@pytest.mark.parametrize("variant", STEPS)
def test_step_grads_match_the_nested_path(run, variant):
    read = _grad_readings(run, f"step_{variant}|grad", "xla|grad")
    worst = max(read, key=read.get)
    assert read[worst] <= GRAD_TOL, (worst, read[worst])
    want = np.sqrt(sum(np.sum(np.square(run.ref[k].astype(np.float64)))
                       for k in run.ref if k.startswith("xla|grad|")))
    for port in run.port:
        got = float(port[f"step_{variant}|gnorm"])
        assert abs(got - want) <= GRAD_TOL * want, (got, want)


@pytest.mark.parametrize("fault", FAULTS)
def test_each_planted_fault_fails_the_raw_grad_check(run, fault):
    read = _grad_readings(run, f"step_{fault}|grad", "xla|grad")
    assert max(read.values()) > GRAD_TOL, read


def test_checkpoint_gathers_the_experts_over_model(tmp_path):
    """``--ckpt`` under a ``model`` axis: rank 0 writes every expert (the
    reference's full tree, in its layout: each expert stack ``(L, E,
    ...)``), its own slice where its params hold it."""
    from repro_torch.launch import train
    res = train.main(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                      "cpu", "--ranks", "4", "--model-parallel", "2",
                      "--steps", "1", "--seq", "32", "--batch", "8",
                      "--ckpt", str(tmp_path)], keep_params=True)
    assert res["experts"] == [[0, 2], [2, 4], [0, 2], [2, 4]]
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    arrays = np.load(tmp_path / "arrays.npz")
    for leaf in manifest["leaves"]:
        if _is_expert(leaf["key"]):
            assert leaf["shape"][:2] == [2, 4], leaf
    for i, lp in enumerate(res["params"]["layers"]):
        got = arrays["params__layers__moe__w_up"][i]
        np.testing.assert_array_equal(got[:2], lp["moe"]["w_up"].numpy())


def test_overlap_under_expert_parallelism_says_it_syncs_in_the_backward(
        capfd):
    """``--overlap-backward`` with experts split over ``model``: the
    launcher says that each layer syncs inside the backward (fused, not
    overlapped) and no second of the step runs on a sync thread."""
    from repro_torch.launch import train
    res = train.main(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                      "cpu", "--ranks", "4", "--model-parallel", "2",
                      "--steps", "2", "--seq", "32", "--batch", "8",
                      "--tuning-table", FLAT, "--overlap-backward"])
    out = capfd.readouterr().out
    assert "each layer synced inside the backward" in out, out
    assert "fused, not overlapped" in out
    assert "backward-overlapped release streams" not in out
    assert res["release_sync_s"] == [0.0, 0.0]
    assert res["release_events"] == [[[1, 0]] * 4] * 2
