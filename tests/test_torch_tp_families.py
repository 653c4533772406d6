"""Tensor parallelism in training for every family but smollm's dense
one (``tests/test_torch_tp.py``), against the JAX package.

- The layout: for every leaf of every family without experts (the dense
  families smollm-135m and qwen2.5-3b, whose query/key/value biases
  split too, llava-next-mistral-7b, whisper-large-v3, zamba2-2.7b,
  mamba2-130m) and a ``model`` axis of 2 and 4, the port's
  `sharding.tp_dim` of its per-layer leaf is the dimension at which the
  reference's ``param_specs`` puts ``"model"``, after its stacked lead
  dimension is removed; at the full config and the reduced one (shape
  structs only, no draw).
- Loss and gradients at fp32 on the 2x2 ``("data", "model")`` mesh, the
  reference in one subprocess with 4 simulated devices, the port in one
  4-rank group (as ``tests/test_torch_tp.py`` does): reduced llava
  (query heads split, its one kv head whole), whisper (encoder, decoder
  and cross-attention split; the encoder's output enters the
  cross-attention once), zamba2 (the shared block split, the mamba
  layers whole) and mamba2 (only the embedding and the head split).
  Each rank's gradients within 1e-3 of each leaf's scale against its
  slice of the reference's, the loss within 1e-5.
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
from repro_torch.configs import ARCHITECTURES  # noqa: E402
from repro_torch.core.collectives import group as grp  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

from test_torch_tp import (  # noqa: E402
    BATCH,
    GRAD_TOL,
    LOSS_TOL,
    REF_SCRIPT,
    ROOT,
    SEQ,
    loss_and_grads,
    ref_slice,
)

LAYOUT_ARCHS = ("smollm-135m", "qwen2.5-3b", "llava-next-mistral-7b",
                "whisper-large-v3", "zamba2-2.7b", "mamba2-130m")
PARITY_ARCHS = ("llava-next-mistral-7b", "whisper-large-v3", "zamba2-2.7b",
                "mamba2-130m")


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
def _reference_layout(arch, tp, reduced):
    """``{key: (shape, spec)}`` of the reference's params, stacked."""
    cfg = JARCH[arch].reduced() if reduced else JARCH[arch]
    shapes = jax.eval_shape(
        lambda: jbuild(cfg).init(jax.random.PRNGKey(0)))
    mesh = types.SimpleNamespace(shape={"data": 1, "model": tp},
                                 axis_names=("data", "model"))
    specs = jsh.param_specs(shapes, cfg, JParallel(), mesh)
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


@pytest.mark.parametrize("tp", (2, 4))
@pytest.mark.parametrize("arch,key", LEAVES)
def test_tp_dim_is_where_param_specs_puts_model(arch, key, tp):
    for reduced in (True, False):
        shape, spec = _reference_layout(arch, tp, reduced)[key]
        path = tuple(key.split("/"))
        off = 1 if path[0] in bridge.STACKED else 0
        want = spec.index("model") - off if "model" in spec else None
        assert sh.tp_dim(path, shape[off:], tp) == want, \
            (key, reduced, shape, spec)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_families")
    cfg = {"seq": SEQ, "batch": BATCH, "archs": list(PARITY_ARCHS),
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
        ref=dict(np.load(cfg["out"])),
        port=[dict(np.load(tmp / f"r{r}.npz")) for r in range(4)])


def _rank_work(ref_path, out_dir):
    from repro_torch.launch.mesh import make_local_mesh
    ref = dict(np.load(ref_path))
    mesh = make_local_mesh(2, device="cpu")
    out = {"model": np.asarray(grp.rank(mesh.axis("model")))}
    loss_and_grads(ref, mesh, out, PARITY_ARCHS)
    np.savez(os.path.join(out_dir, f"r{grp.rank()}.npz"), **out)


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_loss_and_grads_match_reference(run, arch):
    read, split = {}, 0
    for port in run.port:
        np.testing.assert_allclose(port[f"{arch}|loss"],
                                   run.ref[f"{arch}|loss"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        m = int(port["model"])
        prefix = f"{arch}|grad|"
        keys = [k for k in port if k.startswith(prefix)]
        assert keys
        for k in keys:
            want = run.ref[k]
            if want.shape != ref_slice(k[len(prefix):], want, m).shape:
                split += 1
            want = ref_slice(k[len(prefix):], want, m)
            got = port[k]
            assert got.shape == want.shape, (k, got.shape, want.shape)
            scale = float(np.abs(want).max()) or 1.0
            read[k] = max(read.get(k, 0.0),
                          float(np.abs(got - want).max()) / scale)
    worst = max(read, key=read.get)
    assert read[worst] <= GRAD_TOL, (worst, read[worst])
    assert split >= 4 * 2        # at least tok and out on every rank
