"""The port's attention kernels module against the JAX package.

The same numpy inputs go through JAX's Pallas flash attention (interpret
mode, as ``tests/test_kernels.py`` runs it on the CPU), JAX's
``ref.attention``, and the port's plain flash attention and
``ops.attention`` on CPU tensors, over the reference's sweep and
tolerances. The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

HERE = os.path.dirname(__file__)
# the reference's tolerances (tests/test_kernels.py), bf16 compared in fp32
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SHAPES = [
    (1, 128, 128, 4, 4, 64),     # MHA
    (2, 256, 256, 4, 2, 64),     # GQA
    (1, 128, 128, 4, 1, 128),    # MQA, 128 head dim
    (1, 96, 96, 2, 2, 80),       # non-multiple-of-block seq, odd head dim
]


def _qkv(B, S, T, H, KV, D, dtype, seed=0):
    """The same values for both packages: numpy fp32, rounded to bf16 the
    same way (round-to-nearest-even) by each framework."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D))]
    j = [jnp.asarray(a, JDT[dtype]) for a in arrs]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,KV,D", SHAPES)
def test_plain_flash_attention_matches_pallas_causal(dtype, B, S, T, H, KV, D):
    (jq, jk, jv), (q, k, v) = _qkv(B, S, T, H, KV, D, dtype)
    want_kernel = jops.attention(jq, jk, jv, causal=True, impl="interpret")
    want_ref = jref.attention(jq, jk, jv, causal=True)
    got = fa.flash_attention_plain(q, k, v, causal=True)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, D)
    _close(got, want_kernel, TOL[dtype])
    _close(got, want_ref, TOL[dtype])
    _close(ops.attention(q, k, v, causal=True, impl="auto"), want_ref,
           TOL[dtype])


@pytest.mark.parametrize("window", [1, 17, 64, 256])
def test_plain_flash_attention_window(window):
    (jq, jk, jv), (q, k, v) = _qkv(1, 256, 256, 2, 2, 64, "float32", seed=1)
    want = jops.attention(jq, jk, jv, causal=True, window=window,
                          impl="interpret")
    got = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    _close(got, want, 2e-5)
    _close(got, jref.attention(jq, jk, jv, causal=True, window=window), 2e-5)


def test_plain_flash_attention_decode_offset():
    S = 200
    (jq, jk, jv), (q, k, v) = _qkv(2, 1, S, 4, 2, 64, "float32", seed=2)
    want = jops.attention(jq, jk, jv, causal=True, q_offset=S - 1,
                          impl="interpret")
    got = fa.flash_attention_plain(q, k, v, causal=True, q_offset=S - 1)
    _close(got, want, 2e-5)


def test_fully_masked_rows_are_zero():
    """Rows whose every key is masked (queries before position 0) come
    out 0, not NaN, in the reference and the port alike."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 40, 40, 2, 1, 64, "float32", seed=3)
    want = jref.attention(jq, jk, jv, causal=True, q_offset=-5)
    got = fa.flash_attention_plain(q, k, v, causal=True, q_offset=-5)
    assert torch.isfinite(got).all() and (got[:, :5] == 0).all()
    _close(got, want, 2e-5)


@pytest.mark.parametrize("impl,jfn", [
    ("ref", jref.attention),
    ("xla", jref.attention_xla_chunked),
])
@pytest.mark.parametrize("window", [0, 37])
def test_ops_plain_paths_match_jax(impl, jfn, window):
    (jq, jk, jv), (q, k, v) = _qkv(2, 600, 600, 6, 2, 64, "float32", seed=4)
    want = jfn(jq, jk, jv, causal=True, window=window)
    got = ops.attention(q, k, v, causal=True, window=window, impl=impl)
    _close(got, want, 2e-5)


def test_plain_chunked_matches_quadratic():
    _, (q, k, v) = _qkv(2, 512, 512, 3, 3, 64, "float32", seed=5)
    want = ref.attention(q, k, v, causal=True)
    got = ref.attention_xla_chunked(q, k, v, causal=True, chunk=128)
    _close(got, want, 2e-5)


def test_cpu_tensors_never_count_a_launch():
    _, (q, k, v) = _qkv(1, 64, 64, 2, 1, 64, "bfloat16", seed=6)
    before = fa.launches
    ops.attention(q, k, v, causal=True, impl="auto")
    fa.flash_attention(q, k, v, causal=True)
    assert fa.launches == before == 0


def _view(case, dtype):
    """A (1, 8, 2, 64) q of ``dtype`` whose rows are off 16 bytes (for
    bf16) in one way."""
    if case == "seq_stride":         # 2*64 + 4 elements between positions
        return torch.zeros(2000, dtype=dtype).as_strided(
            (1, 8, 2, 64), (8 * 132, 132, 64, 1))
    if case == "head_stride":        # 68 elements between heads
        return torch.zeros((1, 8, 2, 68), dtype=dtype)[..., :64]
    buf = torch.zeros(8 * 2 * 64 + 8, dtype=dtype)
    off = next(o for o in range(8)                   # base 8 bytes off
               if (buf.data_ptr() + o * buf.element_size()) % 16 == 8)
    return buf[off:off + 8 * 2 * 64].reshape(1, 8, 2, 64)


@pytest.mark.parametrize("case", ["seq_stride", "head_stride", "base_offset"])
def test_bf16_kernel_check_refuses_rows_off_16_bytes(case):
    """The wrapper's check before the bf16 tensor-core kernel (its
    cp.async copies take 16-byte rows): a position stride, a head stride
    or a base off 16 bytes raises; aligned views of a fused projection
    pass, and the fp32 (SIMT) kernel takes the same strides."""
    kv = torch.zeros((1, 8, 1, 64), dtype=torch.bfloat16)
    fa._check(torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16), kv, kv)
    fused = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    fa._check(fused[:, :, :2], fused[:, :, 2:3], fused[:, :, 3:])
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fa._check(_view(case, torch.bfloat16), kv, kv)
    fa._check(_view(case, torch.float32), kv.float(), kv.float())


def test_other_devices_raise_instead_of_falling_back():
    # meta tensors take the accounting's meta path: the kernel's output,
    # no launch, no plain version; tensors on two devices raise
    q = torch.empty((1, 8, 2, 64), device="meta")
    before = fa.launches
    out = fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert out.device.type == "meta" and out.shape == q.shape
    assert fa.launches == before
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention(q, torch.empty((1, 8, 1, 64)),
                           torch.empty((1, 8, 1, 64)))
    with pytest.raises(ValueError, match="unknown attention impl"):
        ops.attention(q, q, q, impl="pallas")


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib')) or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for m in ('kernels.ssd_scan', 'models.ssm', 'models.hybrid', "
        "'configs.mamba2_130m', 'configs.zamba2_2p7b', "
        "'kernels.segment_reduce', 'core.collectives.group', "
        "'core.collectives.algorithms', 'core.collectives.program', "
        "'core.collectives.synth', 'core.tuning.executor', "
        "'core.tuning.tuners', 'launch.measure_collectives', "
        "'kernels.paged_attention', 'models.moe', 'models.moe_model', "
        "'configs.olmoe_1b_7b', 'configs.arctic_480b', "
        "'comms', 'comms.communicator', 'comms.bucketing', 'comms.probe', "
        "'comms.report', 'comms.request', 'obs', 'obs.trace', "
        "'obs.metrics', 'core.topology', 'core.topology.model', "
        "'core.topology.decision', 'core.analytical.costs', "
        "'core.analytical.fitting', 'core.analytical.hierarchy', "
        "'core.collectives.hierarchical', 'core.collectives.schedule', "
        "'core.tuning.preprocess', 'core.tuning.regression', "
        "'core.tuning.ann', 'core.tuning.ensemble', "
        "'core.tuning.decision_tree', 'core.tuning.quadtree', "
        "'core.tuning.octree', 'core.tuning.star', 'core.tuning.feedback', "
        "'core.tuning.umtac', 'core.topology.placement', "
        "'core.topology.tune', 'pytree', 'kernels.attention_bwd', "
        "'configs.shapes', 'optim', 'optim.adamw', 'optim.schedule', "
        "'data', 'data.pipeline', 'parallel.sharding', 'launch.mesh', "
        "'launch.steps', 'launch.train', 'checkpoint', 'checkpoint.ckpt', "
        "'bridge', 'models.encdec', 'models.vlm', "
        "'configs.whisper_large_v3', 'configs.llava_next_mistral_7b'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "print('imported', sum(n.startswith('repro_torch') for n in sys.modules))\n")
    root = os.path.join(HERE, "..")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(root, "src"), root])
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 40
