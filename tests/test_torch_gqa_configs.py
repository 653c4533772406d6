"""glm4-9b, chatglm3-6b, qwen2.5-3b and arctic-480b at their own query
groups, against the JAX package.

``ModelConfig.reduced()`` caps the query heads at 4, which takes every
grouped configuration down to one kv head: there every mapping from
query head to kv head gives the same answer. Here each runs at
``reduced()`` with its own ``num_heads`` / ``num_kv_heads`` restored
(32/2, 32/2, 16/2 and 56/8: groups of 16, 16, 8 and 7), head dim 16 and
``d_model = H x 16``:

- prefill and 4 greedy decode steps through the parameter bridge: fp32
  logits within 1e-4 with the tokens equal, bf16 within 2e-2 of the
  largest logit (the reference's tokens teacher-forced; arctic's tokens
  routed to all 4 experts there, since one bf16 ulp flips a near tie of
  the router's top 2);
- the port's continuous engine (paged KV, 2 slots) gives the tokens of
  the dense decode over the same requests (batched as the engine's
  slots; for arctic, whose engine routes each row alone, each request
  alone);
- loss within 1e-5 and every gradient within 1e-3 of
  ``jax.value_and_grad`` of the reference's loss, at fp32;
- qwen2.5-3b at 16/2 on a ``(1 data, 2 model)`` mesh, one spawned
  2-rank gloo group against the reference on 2 simulated devices: each
  rank holds 8 query heads, 1 kv head and its slice of the QKV biases
  (the split-kv-head layout); the loss (1e-5) and each rank's corrected
  gradients (1e-3 of the leaf's scale) against its slice of the
  reference's, as ``tests/test_torch_tp_families.py`` holds them, and
  one untuned training step's loss and synced gradients against the
  reference's step, as ``tests/test_torch_tp.py`` holds them, and its
  params' change over the whole tree (1e-2);
- ``launch.serve.main(argv, config=...)`` replaces fields of the config:
  arctic-480b cut to one layer serves its requests.
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
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as JARCH  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import make_train_batch as jmake  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.configs import ARCHITECTURES  # noqa: E402
from repro_torch.core.collectives import group as grp  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

from test_torch_serving import _clone, _engine_tokens, _oracle  # noqa: E402
# one intra-op thread for the module, as tests/test_torch_train.py runs:
# beside the suite's other workers a pool a core starves them all
from test_torch_train import one_intra_op_thread  # noqa: E402,F401
from test_torch_tp import (  # noqa: E402
    GRAD_TOL,
    LOSS_TOL,
    ROOT,
    STEP_CHANGE_TOL,
    STEP_LOSS_TOL,
    inputs,
    port_flat,
    ref_slice,
    value_and_grad,
)

#: each configuration's own (query heads, kv heads)
HEADS = {"glm4-9b": (32, 2), "chatglm3-6b": (32, 2), "qwen2.5-3b": (16, 2),
         "arctic-480b": (56, 8)}
ARCHS = tuple(HEADS)
HEAD_DIM = 16
MODEL_TOL = 1e-4
BF16_TOL = 2e-2          # of the largest logit
DECODE_STEPS = 4
TP_ARCH = "qwen2.5-3b"
TP_SEQ, TP_BATCH = 16, 2


def grouped(arch):
    """``reduced()`` with the config's own heads restored."""
    H, KV = HEADS[arch]
    return dict(num_heads=H, num_kv_heads=KV, head_dim=HEAD_DIM,
                d_model=H * HEAD_DIM)


def _cfgs(arch):
    kw = grouped(arch)
    return JARCH[arch].reduced().replace(**kw), \
        ARCHITECTURES[arch].reduced().replace(**kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """Params of the reference's layout at ``arch``'s grouped config,
    drawn with numpy (read only: every test takes a copy through the
    bridge): each weight at the reference's init scale (1 / sqrt(fan
    in)), the QKV biases and the norm scales off their zero and one
    inits so that those paths count."""
    cfg_j, _ = _cfgs(arch)
    api = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="xla")
    shapes = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.normal(size=leaf.shape)
        if name in ("ln1", "ln2", "final_norm"):
            x = 1 + 0.1 * x
        elif name in ("bq", "bk", "bv"):
            x = 0.1 * x
        else:
            x = x / np.sqrt(leaf.shape[-2] if name == "w_down"
                            else cfg_j.d_model)
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_configs_keep_their_groups(arch):
    """The port's params at these configs: every kv head serves its own
    group of query heads (a group above 1 and more than one kv head)."""
    _, cfg = _cfgs(arch)
    H, KV = HEADS[arch]
    assert H // KV in (16, 8, 7) and KV > 1 and H % KV == 0
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    attn = params["layers"][0]["attn"]
    assert attn["wq"].shape[1:] == (H, HEAD_DIM)
    assert attn["wk"].shape[1:] == (KV, HEAD_DIM)
    assert ("bq" in attn) == cfg.qkv_bias


def _decode_both(arch, compute):
    cfg_j, cfg = _cfgs(arch)
    if compute == "bfloat16" and cfg.num_experts:
        # every token to all 4 experts: at bf16 one ulp of the residual
        # flips a near tie of the router's top 2 (arctic's layer 1: two
        # router logits 0.0036 apart), a discrete change no tolerance on
        # the logits holds; fp32 keeps the top-2 routing
        top = dict(experts_per_token=cfg.num_experts)
        cfg_j, cfg = cfg_j.replace(**top), cfg.replace(**top)
    pn = _jax_params(arch)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute]
    japi = jbuild(cfg_j, compute_dtype=jdt, attn_impl="xla")
    api = build_model(cfg, compute_dtype=tdt, device="cpu")
    jparams, params = jax.tree.map(jnp.asarray, pn), bridge.from_jax(pn)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 10))
    jl, jc = jax.jit(japi.prefill, static_argnums=2)(
        jparams, jnp.asarray(prompt, jnp.int32), 16)
    with torch.inference_mode():
        tl, tc = api.prefill(params, torch.from_numpy(prompt), 16)
    steps = [(tl, jl)]
    jstep = jax.jit(japi.decode_step)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl[:, -1], -1)[:, None]
    for _ in range(DECODE_STEPS):
        if compute == "bfloat16":        # teacher-force the reference's tokens
            ttok = torch.from_numpy(np.asarray(jtok, np.int64))
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist()
        jl, jc = jstep(jparams, jc, jtok)
        with torch.inference_mode():
            tl, tc = api.decode_step(params, tc, ttok)
        steps.append((tl, jl))
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl, -1)[:, None]
    return steps


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, compute):
    for tl, jl in _decode_both(arch, compute):
        got, want = _np(tl), _np(jl)
        if compute == "float32":
            np.testing.assert_allclose(got, want, atol=MODEL_TOL,
                                       rtol=MODEL_TOL)
        else:
            err = np.abs(got - want).max()
            assert err <= BF16_TOL * np.abs(want).max(), err


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_the_dense_decode(arch):
    """Two slots; the dense decode batches the engine's slots, except
    for arctic, whose engine routes each row as its own group (the
    reference's vmap of batch-1 decodes): there the dense decode takes
    each request alone, since two rows sharing the experts' capacity (1
    slot an expert at 2 x 2 choices over 4) drop tokens that one row
    alone keeps."""
    from repro_torch.serve import synthetic_trace
    _, cfg = _cfgs(arch)
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        params = api.init(torch.Generator().manual_seed(0))
    trace = synthetic_trace(4, rate_rps=500.0, vocab=cfg.vocab_size,
                            prompt_lens=(4, 6), max_new=6, seed=0)
    view_len = 12
    got = _engine_tokens(api, params, _clone(trace), max_active=2,
                         view_len=view_len)
    assert len(got) == 4
    assert got == _oracle(api, params, _clone(trace), view_len,
                          1 if cfg.family == "moe" else 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    cfg_j, cfg = _cfgs(arch)
    shape = JShape(name="t", seq_len=32, global_batch=2, kind="train")
    japi = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="ref")
    pn = _jax_params(arch)
    batch = jmake(cfg_j, shape, seed=2)
    (want, _), gj = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, pn), batch)
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    got, gt = value_and_grad(api, bridge.from_jax(pn),
                             bridge.batch_from_jax(
                                 jax.tree.map(np.asarray, batch)))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    gl = pytree.leaves(bridge.to_reference(gt))
    wl = jax.tree.leaves(gj)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# qwen2.5-3b's heads split over model = 2: 8 query heads and 1 kv head a rank
# ---------------------------------------------------------------------------
REF_TP = r"""
import json, os, sys
cfg_in = json.load(open(sys.argv[1]))
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
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
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}

arch = cfg_in["arch"]
mesh = compat.make_mesh((1, 2), ("data", "model"))
shape = ShapeConfig(name="tp", seq_len=cfg_in["seq"],
                    global_batch=cfg_in["batch"], kind="train")
cfg = get_config(arch).reduced().replace(**cfg_in["config"])
batch = make_train_batch(cfg, shape, seed=7)
params = build_model(cfg, attn_impl="xla").init(jax.random.PRNGKey(2))
rng = np.random.default_rng(2)
for name in ("bq", "bk", "bv"):      # the biases off their zero init
    a = params["layers"]["attn"][name]
    params["layers"]["attn"][name] = jnp.asarray(
        0.1 * rng.normal(size=a.shape), jnp.float32)
out = {f"{arch}|params|{k}": v for k, v in flat(params).items()}
out.update({f"{arch}|batch|{k}": np.asarray(v) for k, v in batch.items()})
sh.set_current_mesh(mesh)
pspecs = sh.param_specs(jax.eval_shape(lambda: params), cfg,
                        ParallelConfig(), mesh)
placed = jax.device_put(params, sh.to_named(pspecs, mesh))
api = build_model(cfg, compute_dtype=jnp.float32, attn_impl="xla")
loss, g = jax.jit(jax.value_and_grad(
    lambda p, b: api.loss(p, b)[0]))(placed, batch)
out[f"{arch}|loss"] = np.asarray(loss)
out.update({f"{arch}|grad|{k}": v for k, v in flat(g).items()})
# the step builds its model in the default (bf16) compute dtype, whatever
# ParallelConfig says: here it computes in fp32
rsteps.build_model = lambda c, **kw: build_model(
    c, compute_dtype=jnp.float32, **kw)
fn, _, in_sh, out_sh, _ = build_train_step(
    cfg, shape, ParallelConfig(compute_dtype="float32"), CollectiveConfig(),
    mesh, warmup_steps=0)
opt = jax.device_put(AdamW(lr=3e-4).init(params), in_sh[1])
new_p, _, m = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
    placed, opt, batch)
out[f"{arch}|step|loss"] = np.asarray(m["loss"])
out.update({f"{arch}|step|params|{k}": v
            for k, v in flat(jax.device_get(new_p)).items()})
sh.set_current_mesh(None)
np.savez(cfg_in["out"], **out)
print("ok")
"""


def _tp_rank(ref_path, out_dir):
    """One rank of (1 data, 2 model): the loss and corrected gradients of
    the split model, then one untuned fp32 training step."""
    from repro_torch.configs import ParallelConfig, ShapeConfig
    from repro_torch.configs.base import CollectiveConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding as sh
    ref = dict(np.load(ref_path))
    mesh = make_local_mesh(2, device="cpu")
    _, cfg = _cfgs(TP_ARCH)
    full, batch = inputs(ref, TP_ARCH, sh.batch_rows(mesh, TP_BATCH))
    params = sh.tp_shard(full, mesh)
    out = {"model": np.asarray(grp.rank(mesh.axis("model")))}
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu",
                      tp_axis="model", mesh=mesh)
    loss, g = value_and_grad(api, params, batch)
    out["loss"] = loss.numpy()
    for k, v in port_flat(steps.tp_correct(g, mesh, cfg)).items():
        out[f"grad|{k}"] = v
    shape = ShapeConfig(name="tp", seq_len=TP_SEQ, global_batch=TP_BATCH,
                        kind="train")
    step = steps.build_train_step(
        cfg, shape, ParallelConfig(compute_dtype="float32"),
        CollectiveConfig(), mesh, warmup_steps=0, device="cpu")
    assert step.tp_axis == "model"
    new_p, _, m = step.fn(params, step.opt.init(params), batch,
                          keep_grads=True)
    out["step_loss"] = np.asarray(float(m["loss"]))
    for k, v in port_flat(new_p).items():
        out[f"step_params|{k}"] = v
    for k, v in port_flat(m["grads"]).items():
        out[f"step_grad|{k}"] = v
    np.savez(os.path.join(out_dir, f"r{grp.rank()}.npz"), **out)


@pytest.fixture(scope="module", autouse=True)
def tp_reference(tmp_path_factory):
    """The reference's side of the split-kv-head check, started before
    the module's first test so that its compiles run beside them."""
    tmp = tmp_path_factory.mktemp("gqa_tp")
    cfg = {"arch": TP_ARCH, "config": grouped(TP_ARCH), "seq": TP_SEQ,
           "batch": TP_BATCH, "out": str(tmp / "ref.npz")}
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_TP, str(tmp / "cfg.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        yield types.SimpleNamespace(proc=proc, dir=tmp, out=cfg["out"])
    finally:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def tp_run(tp_reference):
    out, err = tp_reference.proc.communicate(timeout=600)
    assert tp_reference.proc.returncode == 0, out + err[-4000:]
    tmp = tp_reference.dir
    grp.spawn(_tp_rank, 2, (tp_reference.out, str(tmp)), timeout_s=300)
    return types.SimpleNamespace(
        ref=dict(np.load(tp_reference.out)),
        port=[dict(np.load(tmp / f"r{r}.npz")) for r in range(2)])


def _readings(run, port_prefix, ref_prefix):
    """Per leaf, the max over ranks of |got - want| / max|want|, each
    rank against its slice of the reference's leaf."""
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


@pytest.mark.parametrize("what", ["loss_and_gradients", "step"])
def test_split_kv_heads_match_the_reference(tp_run, what):
    port = tp_run.port[0]
    # the split-kv-head layout: 8 query heads, 1 kv head and their biases
    # a rank (stacked: layers, d, heads, head dim)
    assert port["grad|layers/attn/wq"].shape[2] == 8
    assert port["grad|layers/attn/wk"].shape[2] == 1
    assert port["grad|layers/attn/wv"].shape[2] == 1
    assert port["grad|layers/attn/bq"].shape[1] == 8
    assert port["grad|layers/attn/bk"].shape[1] == 1
    if what == "loss_and_gradients":
        for p in tp_run.port:
            np.testing.assert_allclose(p["loss"],
                                       tp_run.ref[f"{TP_ARCH}|loss"],
                                       rtol=LOSS_TOL, atol=LOSS_TOL)
        read = _readings(tp_run, "grad", f"{TP_ARCH}|grad")
    else:
        for p in tp_run.port:
            assert abs(float(p["step_loss"])
                       - float(tp_run.ref[f"{TP_ARCH}|step|loss"])) < \
                STEP_LOSS_TOL
        # the params' change over the whole tree, as chip_smoke.py's
        # change_reading holds it: Adam's first step is g / (|g| + eps),
        # and a few of bk's gradient entries lie within 1e-8 of 0 (the
        # bias's rotated copies nearly cancel over the keys), where the
        # order of a sum flips a leaf-sized share of its update
        num = den = 0.0
        for p in tp_run.port:
            m = int(p["model"])
            for k in [k for k in p if k.startswith("step_params|")]:
                leaf = k.split("|", 1)[1]
                init = ref_slice(leaf, tp_run.ref[f"{TP_ARCH}|params|{leaf}"],
                                 m).astype(np.float64)
                want = ref_slice(
                    leaf, tp_run.ref[f"{TP_ARCH}|step|params|{leaf}"], m)
                num += float(np.square(p[k] - want.astype(np.float64)).sum())
                den += float(np.square(want - init).sum())
        assert den > 0 and (num / den) ** 0.5 <= STEP_CHANGE_TOL, \
            (num / den) ** 0.5
        read = _readings(tp_run, "step_grad", f"{TP_ARCH}|grad")
    worst = max(read, key=read.get)
    assert read[worst] <= GRAD_TOL, (worst, read[worst])


# ---------------------------------------------------------------------------
# serve.main(argv, config=...)
# ---------------------------------------------------------------------------
def test_serve_main_replaces_fields_of_the_config(capsys):
    res = launch_serve.main([
        "--arch", "arctic-480b", "--reduced", "--device", "cpu",
        "--continuous", "--num-requests", "3", "--poisson-rate", "200",
        "--prompt-len", "8", "--gen", "3", "--max-active", "2",
        "--block-size", "4"], config={"num_layers": 1})
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out
    assert all(len(t) == 3 for t in res["generated"].values())
    assert res["num_layers"] == 1
    cfg = ARCHITECTURES["arctic-480b"].reduced().replace(num_layers=1)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert res["param_elems"] == sum(t.numel()
                                     for t in pytree.leaves(params))
    # without it, the reduced config's two layers; and no CLI flag for it
    res = launch_serve.main(["--arch", "arctic-480b", "--reduced",
                             "--device", "cpu", "--batch", "1",
                             "--prompt-len", "4", "--gen", "1"])
    assert res["num_layers"] == 2
    with pytest.raises(SystemExit):
        launch_serve.parse_args(["--config", "{}"])
