"""Checkpoints across the two packages: ``repro_torch.checkpoint``
against ``repro.checkpoint``.

For each of the six families at ``.reduced()``, the reference takes one
AdamW step (smollm-135m from its initial params on its loss's gradient
at fp32 compute, a jitted training step; the other five from seeded
params of its init's tree, ``jax.eval_shape``, on seeded gradients,
which fill the same tree without compiling five inits and backwards)
and ``save``s ``{"params", "opt"}``: the port's ``restore`` gives, bit for
bit, ``bridge.from_jax`` / ``bridge.opt_state_from_jax`` of the
reference's tree; the port ``save``s those and the reference's
``restore`` gives, bit for bit, ``bridge.to_reference`` /
``bridge.opt_state_to_reference`` of them; and the two manifests list
the same keys, shapes and dtypes in the same order. For smollm-135m the
port's next step from the reference's checkpoint matches the
reference's next step at ``tests/test_torch_train.py``'s tolerances for
one port step against the reference: the loss within 1e-5 and the
params after AdamW within 1e-5. A bf16 leaf crosses both ways bit for
bit (the reference writes raw 2-byte data, the port fp32 data under
``"bfloat16"``); a file in the port's earlier per-layer layout still
restores; ``launch.train --ckpt`` restores in the reference's
``restore``; ``restore(shard=sharding.shard_leaf ...)`` at every coordinate
of a 2 x 2 mesh (``group.MetaMesh``: no process group) equals
``sharding.shard`` of the whole tree.
"""
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore as jrestore  # noqa: E402
from repro.checkpoint import save as jsave  # noqa: E402
from repro.configs import ARCHITECTURES as JARCH  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import make_train_batch as jmake  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.configs import ARCHITECTURES  # noqa: E402
from repro_torch.core.collectives import group as grp  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import AdamW, AdamWState  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

FAMILIES = ("smollm-135m", "mamba2-130m", "zamba2-2.7b", "olmoe-1b-7b",
            "whisper-large-v3", "llava-next-mistral-7b")
LR = 1e-3
#: tests/test_torch_train.py: one port step against the reference's
LOSS_TOL = 1e-5
STEP_TOL = 1e-5


def _shape(cfg, name="t"):
    seq = 32 + (cfg.num_patches if cfg.family == "vlm" else 0)
    return JShape(name=name, seq_len=seq, global_batch=2, kind="train")


_REF = {}


def _reference(arch):
    """The reference's reduced model, its initial params and one AdamW
    step from them (numpy trees), and for smollm-135m its jitted
    training step; one per family for the module."""
    if arch in _REF:
        return _REF[arch]
    cfg = JARCH[arch].reduced()
    api = jbuild(cfg, compute_dtype=jnp.float32, attn_impl="ref")
    opt = JAdamW(lr=LR)
    step = None
    if arch == "smollm-135m":
        p0 = api.init(jax.random.PRNGKey(0))
        s0 = opt.init(p0)

        @jax.jit
        def step(params, opt_state, batch):
            (loss, _), grads = jax.value_and_grad(api.loss, has_aux=True)(
                params, batch)
            params, opt_state = opt.update(grads, opt_state, params)
            return params, opt_state, loss
        p1, s1, _ = step(p0, s0, jmake(cfg, _shape(cfg), seed=1))
    else:
        leaves, treedef = jax.tree.flatten(
            jax.eval_shape(api.init, jax.random.PRNGKey(0)))
        rng = np.random.default_rng(1)
        p0, grads = (treedef.unflatten([
            jnp.asarray(rng.normal(size=x.shape), x.dtype) for x in leaves])
            for _ in range(2))
        p1, s1 = jax.jit(opt.update)(grads, opt.init(p0), p0)
    tonp = functools.partial(jax.tree.map, np.asarray)
    _REF[arch] = dict(cfg=cfg, step=step, p1=tonp(p1), s1=tonp(s1))
    return _REF[arch]


def _port_tree(ref):
    return {"params": bridge.from_jax(ref["p1"]),
            "opt": bridge.opt_state_from_jax(ref["s1"])}


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _equal_trees(got, want):
    gl, wl = pytree.leaves(got), pytree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", FAMILIES)
def test_checkpoints_cross_both_ways(arch, tmp_path):
    ref = _reference(arch)
    want = _port_tree(ref)
    n_layers = ref["cfg"].num_layers

    # the reference writes, the port reads
    jsave(str(tmp_path / "ref"), {"params": ref["p1"], "opt": ref["s1"]},
          step=1, extra={"arch": arch})
    like = pytree.tree_map(torch.zeros_like, want)
    got, step_no, extra = restore(str(tmp_path / "ref"), like)
    assert step_no == 1 and extra == {"arch": arch}
    assert isinstance(got["opt"], AdamWState)
    assert got["opt"].step.dtype == torch.int32 and \
        int(got["opt"].step) == 1
    assert len(got["params"]["layers" if "layers" in got["params"]
                             else "decoder"]) == n_layers
    _equal_trees(got, want)

    # the port writes, the reference reads
    save(str(tmp_path / "port"), want, step=1, extra={"arch": arch})
    back, step_no, extra = jrestore(
        str(tmp_path / "port"), {"params": ref["p1"], "opt": ref["s1"]})
    assert step_no == 1 and extra == {"arch": arch}
    expect = {"params": bridge.to_reference(want["params"]),
              "opt": bridge.opt_state_to_reference(want["opt"])}
    bl, el = jax.tree.leaves(back), pytree.leaves(expect)
    assert len(bl) == len(el)
    for b, e in zip(bl, el):
        assert b.dtype == e.dtype and b.shape == e.shape
        np.testing.assert_array_equal(b, e)
    for b, r in zip(bl, jax.tree.leaves({"params": ref["p1"],
                                         "opt": ref["s1"]})):
        np.testing.assert_array_equal(b, r)     # the round trip

    # the same files, leaf for leaf
    rows = [(r["key"], r["dtype"], r["shape"])
            for r in _manifest(str(tmp_path / "ref"))["leaves"]]
    assert rows == [(r["key"], r["dtype"], r["shape"])
                    for r in _manifest(str(tmp_path / "port"))["leaves"]]
    keys = [k for k, _, _ in rows]
    assert "opt/.step" in keys and ("int32", []) == \
        tuple(rows[keys.index("opt/.step")][1:])
    assert any(k.startswith("opt/.mu/") for k in keys) and \
        any(k.startswith("opt/.nu/") for k in keys)


def test_port_step_from_the_reference_checkpoint(tmp_path):
    """smollm-135m: the port restores the reference's checkpoint after
    one step and takes the next; the reference takes the same step."""
    ref = _reference("smollm-135m")
    jsave(str(tmp_path / "ck"), {"params": ref["p1"], "opt": ref["s1"]},
          step=1)
    batch = jmake(ref["cfg"], _shape(ref["cfg"]), seed=2)
    p2, _, want_loss = ref["step"](jax.tree.map(jnp.asarray, ref["p1"]),
                                   jax.tree.map(jnp.asarray, ref["s1"]),
                                   batch)

    cfg = ARCHITECTURES["smollm-135m"].reduced()
    api = build_model(cfg, compute_dtype=torch.float32, attn_impl="ref",
                      device="cpu")
    like = {"params": api.init(torch.Generator().manual_seed(5))}
    like["opt"] = AdamW(lr=LR).init(like["params"])
    tree, _, _ = restore(str(tmp_path / "ck"), like)
    params, opt_state = tree["params"], tree["opt"]
    leaves, treedef = pytree.flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    loss, _ = api.loss(treedef.unflatten(leaves),
                       bridge.batch_from_jax(batch))
    grads = treedef.unflatten(list(torch.autograd.grad(loss, leaves)))
    params, opt_state = AdamW(lr=LR).update(grads, opt_state, params)
    assert int(opt_state.step) == 2
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    got = bridge.to_reference(params)
    wl = jax.tree.leaves(jax.tree.map(np.asarray, p2))
    for g, w in zip(pytree.leaves(got), wl):
        np.testing.assert_allclose(g, w, atol=STEP_TOL, rtol=STEP_TOL)


def test_launcher_checkpoint_restores_in_the_reference(tmp_path):
    """``launch.train --ckpt`` (one rank) writes what the reference's
    ``restore`` reads into its own tree: the port's final params and
    AdamW's state, bit for bit."""
    from repro.optim.adamw import AdamWState as JAdamWState
    from repro_torch.launch import train
    res = train.main(["--arch", "smollm-135m", "--reduced", "--device",
                      "cpu", "--steps", "2", "--seq", "32", "--batch", "2",
                      "--ckpt", str(tmp_path)], keep_params=True)
    cfg = JARCH["smollm-135m"].reduced()
    p0 = jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.PRNGKey(0)))
    like = {"params": p0, "opt": JAdamW().init(p0)}
    got, step_no, extra = jrestore(str(tmp_path), like)
    assert step_no == 2 and extra == {"arch": "smollm-135m"}
    assert isinstance(got["opt"], JAdamWState) and int(got["opt"].step) == 2
    want = bridge.to_reference(res["params"])
    gl, wl = jax.tree.leaves(got["params"]), pytree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_array_equal(g, w)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16)


def test_bf16_leaves_cross_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    w = rng.normal(size=(5, 7)).astype(np.float32)
    stack = rng.normal(size=(2, 3, 4)).astype(np.float32)
    jtree = {"params": {"w": jnp.asarray(w, jnp.bfloat16),
                        "layers": {"x": jnp.asarray(stack, jnp.bfloat16)}}}
    # the reference writes raw 2-byte data
    jsave(str(tmp_path / "ref"), jtree)
    with np.load(tmp_path / "ref" / "arrays.npz") as data:
        assert data["params__w"].dtype.itemsize == 2
    like = {"params": {"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                       "layers": [{"x": torch.zeros(3, 4,
                                                    dtype=torch.bfloat16)}
                                  for _ in range(2)]}}
    got, _, _ = restore(str(tmp_path / "ref"), like)
    want = jax.tree.map(_bits, jtree)
    assert got["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["params"]["w"].view(torch.int16).numpy().view(np.uint16),
        want["params"]["w"])
    for i in range(2):
        np.testing.assert_array_equal(
            got["params"]["layers"][i]["x"].view(torch.int16).numpy()
            .view(np.uint16), want["params"]["layers"]["x"][i])

    # the port writes fp32 data under "bfloat16"; the reference casts back
    save(str(tmp_path / "port"), got)
    rows = _manifest(str(tmp_path / "port"))["leaves"]
    assert [(r["key"], r["dtype"], r["shape"]) for r in rows] == [
        ("params/layers/x", "bfloat16", [2, 3, 4]),
        ("params/w", "bfloat16", [5, 7])]
    back, _, _ = jrestore(str(tmp_path / "port"), jtree)
    for b, w_ in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert b.dtype == w_.dtype
        np.testing.assert_array_equal(_bits(b), _bits(w_))


def _old_layout_save(path, tree, step):
    """The port's earlier writer: one key a leaf, its path in the port's
    tree ("/"-joined dict keys and list and tuple indices)."""
    def paths(t, prefix=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from paths(t[k], prefix + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                yield from paths(v, prefix + (str(i),))
        else:
            yield "/".join(prefix)
    os.makedirs(path)
    arrays, rows = {}, []
    for key, leaf in zip(paths(tree), pytree.leaves(tree)):
        arrays[key.replace("/", "__")] = leaf.numpy()
        rows.append({"key": key, "dtype": pytree.dtype_name(leaf.dtype),
                     "shape": list(leaf.shape)})
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, "extra": {}, "leaves": rows}, f)


def test_the_ports_earlier_layout_still_restores(tmp_path):
    cfg = ARCHITECTURES["zamba2-2.7b"].reduced()   # stacked and shared
    api = build_model(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    opt_state = AdamW().init(params)
    opt_state = AdamWState(
        step=torch.tensor(7, dtype=torch.int32),
        mu=pytree.tree_map(lambda t: t + 1, opt_state.mu),
        nu=pytree.tree_map(lambda t: t + 2, opt_state.nu))
    tree = {"params": params, "opt": opt_state}
    _old_layout_save(str(tmp_path / "old"), tree, step=7)
    keys = [r["key"] for r in
            _manifest(str(tmp_path / "old"))["leaves"]]
    assert "opt/0" in keys and "params/layers/1/ln" in keys
    got, step_no, _ = restore(str(tmp_path / "old"),
                              pytree.tree_map(torch.zeros_like, tree))
    assert step_no == 7
    _equal_trees(got, tree)
    # a leaf missing from both layouts is named
    with pytest.raises(KeyError, match="either layout"):
        restore(str(tmp_path / "old"),
                {**pytree.tree_map(torch.zeros_like, tree),
                 "extra_leaf": torch.zeros(2)})


@pytest.mark.parametrize("arch", ("smollm-135m", "olmoe-1b-7b"))
def test_restore_cuts_each_rank_block_with_no_process_group(arch, tmp_path):
    """FSDP with a model axis (tensor-parallel for smollm, expert-parallel
    for olmoe): ``restore(shard=...)`` from a whole-leaf checkpoint at
    each coordinate of ("data", "model") = 2 x 2 equals `sharding.shard`
    of the whole tree there, optimizer state included."""
    cfg = ARCHITECTURES[arch].reduced()
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    opt_state = AdamW().init(params)
    opt_state = AdamWState(
        step=torch.tensor(3, dtype=torch.int32),
        mu=pytree.tree_map(lambda t: torch.randn_like(t), opt_state.mu),
        nu=pytree.tree_map(lambda t: torch.rand_like(t), opt_state.nu))
    whole = {"params": params, "opt": opt_state}
    save(str(tmp_path / "ck"), whole, step=3)
    cut = 0
    for coords in ((0, 0), (0, 1), (1, 0), (1, 1)):
        mesh = grp.MetaMesh((2, 2), ("data", "model"), coords=coords)
        want = sh.shard(whole, mesh, cfg, fsdp=True)
        got, _, _ = restore(
            str(tmp_path / "ck"), pytree.tree_map(torch.zeros_like, want),
            shard=functools.partial(sh.shard_leaf, mesh=mesh, cfg=cfg))
        _equal_trees(got, want)
        cut += sum(a.shape != b.shape for a, b in zip(
            pytree.leaves(want), pytree.leaves(whole)))
    assert cut > 0
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(str(tmp_path / "ck"), pytree.tree_map(torch.zeros_like,
                                                      whole),
                shard=functools.partial(sh.shard_leaf, mesh=mesh, cfg=cfg))
