"""The port's examples (``repro_torch.examples``) against the reference's
``examples/*.py``.

- ``autotune_collectives`` (its CLI, in a subprocess) writes
  ``tuned_decision.json``, ``hierarchical_decision.json`` and
  ``hierarchical_decision_3level.json`` byte for byte as
  ``examples/artifacts/`` holds them, and ``tuned_measurements.json``
  byte for byte as a fresh run of ``examples/autotune_collectives.py``
  writes it (in a subprocess, its working directory a temporary one; the
  committed cache is older than the reference's pipeline and is not the
  yardstick). Both subprocesses start with the module and run while the
  other tests do.
- ``train_e2e``, reduced smollm-135m at fp32 compute, 6 steps, from the
  reference's params (``bridge.from_jax``): each step's loss within
  1e-5 of the reference's loop (``examples/train_e2e.py``'s calls at
  fp32), the tolerance of ``tests/test_torch_train.py`` for the port's
  loss against the reference's; the resumed run bit-equal to an
  uninterrupted one (losses and final params); its mid-run checkpoint
  restored by ``repro.checkpoint.restore``, from which the reference's
  next step's loss is within 1e-5 of the port's.
- ``serve_decode`` at fp32, from the reference's params: its tokens equal
  the reference's decode loop's for windows 0 and 16.
- ``quickstart`` on 2 x 2 gloo ranks, 2 steps: the losses of the
  ``xla``, ``ring`` and ``rabenseifner`` syncs within 5e-3 (the loss
  tolerance of the port's training checks).
- ``measure_real_collectives`` at 2 ranks, 1 trial: a table that the
  reference's ``DecisionTable.load`` reads, covering the example's
  (op, bytes) grid.
"""
import contextlib
import filecmp
import io
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore as jrestore  # noqa: E402
from repro.checkpoint import save as jsave  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.core.tuning import DecisionTable as JDecisionTable  # noqa: E402
from repro.data import SyntheticPipeline as JPipe  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_with_warmup as jcos  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.examples import measure_real_collectives  # noqa: E402
from repro_torch.examples import quickstart, serve_decode, train_e2e  # noqa: E402,E501

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARTIFACTS = os.path.join(ROOT, "examples", "artifacts")
DECISIONS = ("tuned_decision.json", "hierarchical_decision.json",
             "hierarchical_decision_3level.json")
LOSS_TOL = 1e-5         # tests/test_torch_train.py: port loss vs reference
QUICKSTART_TOL = 5e-3   # the training checks' loss tolerance
E2E_STEPS = 6


@pytest.fixture(scope="module", autouse=True)
def autotune_runs(tmp_path_factory):
    """The reference's example and the port's, each in a subprocess
    started with the module; the last test waits for them."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu"}
    ref_dir = tmp_path_factory.mktemp("autotune_ref")
    port_dir = tmp_path_factory.mktemp("autotune_port")
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples",
                                          "autotune_collectives.py")],
            cwd=ref_dir, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True),
        "port": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.examples."
             "autotune_collectives", "--out", str(port_dir)],
            cwd=port_dir, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)}
    runs = {"dirs": {"ref": ref_dir, "port": port_dir}, "procs": procs}
    yield runs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


def _smollm():
    return jget("smollm-135m").reduced(), get_config("smollm-135m").reduced()


# ---------------------------------------------------------------------------
# train_e2e
# ---------------------------------------------------------------------------
def _reference_e2e(cfg, ckpt, steps):
    """examples/train_e2e.py:35-67 at fp32 compute: losses of the first
    half, the checkpoint, the resumed half; also the jitted step."""
    shape = JShape(name="e2e", seq_len=128, global_batch=4, kind="train")
    api = jbuild(cfg, compute_dtype=jnp.float32, attn_impl="xla")
    opt = JAdamW(lr=1e-3)
    params = api.init(jax.random.PRNGKey(0))
    opt_state = opt.init(params)
    pipe = JPipe(cfg, shape, seed=0)

    @jax.jit
    def step(params, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(api.loss, has_aux=True)(
            params, batch)
        lr_scale = jcos(opt_state.step, warmup_steps=5, total_steps=steps)
        params, opt_state = opt.update(grads, opt_state, params,
                                       lr_scale=lr_scale)
        return params, opt_state, loss

    p0 = jax.tree.map(np.asarray, params)
    losses = []
    half = steps // 2
    for i in range(half):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    jsave(ckpt, {"params": params, "opt": opt_state}, step=half)
    restored, start, _ = jrestore(ckpt, {"params": params,
                                         "opt": opt_state})
    params, opt_state = restored["params"], restored["opt"]
    for i in range(start, steps):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    return {"p0": p0, "losses": losses, "step": step, "pipe": pipe,
            "like": {"params": params, "opt": opt_state}}


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The reference's loop and the port's example from the same params:
    checkpointed and resumed, and straight through."""
    tmp = tmp_path_factory.mktemp("e2e")
    cfg_j, cfg = _smollm()
    ref = _reference_e2e(cfg_j, str(tmp / "ref_ck"), E2E_STEPS)
    start = bridge.from_jax(ref["p0"])
    kw = dict(steps=E2E_STEPS, seq=128, batch=4, device="cpu",
              compute_dtype=torch.float32, params=start)
    return {"ref": ref, "start": start, "ckpt": str(tmp / "ck"),
            "resumed": train_e2e.run(cfg, ckpt=str(tmp / "ck"), **kw),
            "straight": train_e2e.run(cfg, **kw)}


def test_train_e2e_losses_match_the_reference(e2e):
    np.testing.assert_allclose(e2e["resumed"]["losses"],
                               e2e["ref"]["losses"], atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    # the caller's params are left as they were
    assert all(torch.equal(a, b) for a, b in zip(
        pytree.leaves(e2e["start"]),
        pytree.leaves(bridge.from_jax(e2e["ref"]["p0"]))))


def test_train_e2e_resumes_bit_equal(e2e):
    assert e2e["resumed"]["losses"] == e2e["straight"]["losses"]
    for a, b in zip(pytree.leaves(e2e["resumed"]["params"]),
                    pytree.leaves(e2e["straight"]["params"])):
        assert torch.equal(a, b)


def test_train_e2e_checkpoint_resumes_in_the_reference(e2e):
    """The port's mid-run checkpoint in the reference's restore, and the
    reference's next step from it."""
    ref, half = e2e["ref"], E2E_STEPS // 2
    got, step_no, _ = jrestore(e2e["ckpt"], ref["like"])
    assert step_no == half and int(got["opt"].step) == half
    batch = {k: jnp.asarray(v)
             for k, v in ref["pipe"].batch_at(half).items()}
    _, _, loss = ref["step"](got["params"], got["opt"], batch)
    np.testing.assert_allclose(float(loss), e2e["resumed"]["losses"][half],
                               atol=LOSS_TOL, rtol=LOSS_TOL)


def test_train_e2e_cli_writes_the_checkpoint_under_out(tmp_path, capsys):
    res = train_e2e.main(["--device", "cpu", "--steps", "2", "--seq", "32",
                          "--batch", "2", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "checkpointed at step 1; resuming..." in out and "done." in out
    assert len(res["losses"]) == 2
    assert sorted(os.listdir(tmp_path / "repro_e2e_ckpt")) == [
        "arrays.npz", "manifest.json"]


# ---------------------------------------------------------------------------
# serve_decode
# ---------------------------------------------------------------------------
def _reference_decode(cfg, window, params):
    """examples/serve_decode.py's loop at fp32 compute."""
    api = jbuild(cfg, window=window, compute_dtype=jnp.float32,
                 attn_impl="xla")
    B, prompt_len, gen = serve_decode.B, serve_decode.PROMPT_LEN, \
        serve_decode.GEN
    cache = api.init_cache(B, window or (prompt_len + gen))
    step = jax.jit(api.decode_step)
    rng = np.random.default_rng(0)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, prompt_len)),
                         jnp.int32)
    for i in range(prompt_len):
        logits, cache = step(params, cache, prompt[:, i:i + 1])
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    out = []
    for _ in range(gen):
        out.append(tok)
        logits, cache = step(params, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    return np.asarray(jnp.concatenate(out, 1))


@pytest.mark.parametrize("window", serve_decode.WINDOWS)
def test_serve_decode_tokens_equal_the_reference(window, capsys):
    cfg_j, cfg = _smollm()
    pj = jbuild(cfg_j, window=window, attn_impl="xla").init(
        jax.random.PRNGKey(0))
    want = _reference_decode(cfg_j, window, pj)
    res = serve_decode.run(cfg, window=window, device="cpu",
                           compute_dtype=torch.float32,
                           params=bridge.from_jax(jax.tree.map(np.asarray,
                                                               pj)))
    assert res["tokens"].shape == (serve_decode.B, serve_decode.GEN)
    np.testing.assert_array_equal(res["tokens"].numpy(), want)
    assert "tok/s" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# quickstart, measure_real_collectives
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def quickstart_runs():
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = quickstart.main(["--device", "cpu", "--topology", "2x2",
                               "--steps", "2"])
    return out, printed.getvalue()


def test_quickstart_runs_each_algorithm_on_data_by_model(quickstart_runs):
    out, printed = quickstart_runs
    assert sorted(out) == sorted(quickstart.ALGORITHMS)
    for algo, res in out.items():
        assert res["mesh"] == {"data": 2, "model": 2}, algo
        assert len(res["losses"]) == 2 and all(res["replicas_equal"])
        assert res["tuned"] == (algo != "xla"), algo
        assert f"gradient sync = {algo}" in printed


@pytest.mark.parametrize("algo", ("ring", "rabenseifner"))
def test_quickstart_losses_match_xla(quickstart_runs, algo):
    out, _ = quickstart_runs
    np.testing.assert_allclose(out[algo]["losses"], out["xla"]["losses"],
                               atol=QUICKSTART_TOL, rtol=0)


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("measured")
    res = measure_real_collectives.run(str(tmp), device="cpu", ranks=2,
                                       trials=1)
    path = tmp / measure_real_collectives.OUT_NAME
    assert res["out"] == str(path)
    return JDecisionTable.load(str(path))


@pytest.mark.parametrize("op", ("all_reduce", "broadcast"))
def test_measure_real_collectives_table_covers_the_grid(measured, op):
    for m in measure_real_collectives.SIZES:
        assert (op, 2, m) in measured.table, (op, m)


# ---------------------------------------------------------------------------
# autotune_collectives (last: its subprocesses ran beside the tests above)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def autotune_done(autotune_runs):
    for name, p in autotune_runs["procs"].items():
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, (name, out[-3000:])
    return autotune_runs["dirs"]["ref"], autotune_runs["dirs"]["port"]


@pytest.mark.parametrize("name", DECISIONS)
def test_autotune_decisions_equal_the_reference(autotune_done, name):
    ref, port = autotune_done
    assert filecmp.cmp(port / name, os.path.join(ARTIFACTS, name),
                       shallow=False)
    assert filecmp.cmp(port / name, ref / name, shallow=False)


def test_autotune_measurements_equal_a_fresh_reference_run(autotune_done):
    ref, port = autotune_done
    assert filecmp.cmp(port / "tuned_measurements.json",
                       ref / "tuned_measurements.json", shallow=False)
