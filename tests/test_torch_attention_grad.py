"""Gradients of the port's flash attention against the JAX package.

The reference trains through its attention under ``jax.value_and_grad``;
its oracle is ``repro.kernels.ref.attention`` (the Pallas kernel has no
gradient in interpret mode, ``tests/test_kernels.py:100-118``). The same
numpy q, k, v and output cotangent go through ``jax.grad`` of the oracle
and through the port: ``flash_attention_bwd_plain`` from the forward's
row log-sum-exp, and autograd through ``ops.attention(impl="auto")`` on
CPU tensors (the plain forward and backward of the kernels). Tolerance
1e-3, ``tests/test_kernels.py``'s for the gradient. Cases: causal,
window, GQA and MQA, fully masked rows (zero gradient), T != S, no
causal mask. The same cases in bf16 (inputs bf16-representable, so the
reference sees the very values) hold ``flash_attention_bwd_mma_plain``,
the bf16 tensor-core kernels' algebra (P and dS rounded to bf16, the
GQA partials summed in head order), to the reference's gradient at its
bf16 tolerance, 2e-2 (``tests/test_kernels.py:17``), and to
``flash_attention_bwd_plain`` on the same bf16 inputs.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import attention_bwd as fa_bwd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 1e-3
CASES = [
    (1, 64, 64, 4, 4, 64, {}),
    (2, 96, 96, 4, 2, 64, {}),                        # GQA
    (1, 64, 64, 4, 1, 128, {}),                       # MQA, D = 128
    (1, 80, 80, 2, 2, 80, {"window": 17}),            # window, D = 80
    (1, 40, 40, 2, 1, 64, {"q_offset": -5}),          # fully masked rows
    (2, 48, 100, 3, 1, 64, {"causal": False}),        # T != S
    (1, 16, 100, 2, 1, 64, {"q_offset": 84, "window": 40}),
]
IDS = [f"{c[:6]}{c[6]}".replace(" ", "") for c in CASES]


def _inputs(B, S, T, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D),
                      (B, S, H, D))]


def _bf16_exact(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


@functools.lru_cache(maxsize=None)
def _case(i, bf16=False):
    """Case i's inputs, the reference's output and its gradients (the
    tests of a case share them); with ``bf16`` the inputs are rounded to
    bf16 values first."""
    B, S, T, H, KV, D, kw = CASES[i]
    kw = {"causal": True, **kw}
    q, k, v, w = _inputs(B, S, T, H, KV, D, seed=S + T)
    if bf16:
        q, k, v, w = (_bf16_exact(a) for a in (q, k, v, w))

    @jax.jit
    def f(q, k, v):
        out = jref.attention(q, k, v, **kw)
        return jnp.sum(out * w), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return (q, k, v, w), kw, np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_plain_backward_matches_jax_grad(i):
    (q, k, v, w), kw, _, want = _case(i)
    qt, kt, vt, wt = (torch.from_numpy(a) for a in (q, k, v, w))
    out, lse = fa.flash_attention_fwd(qt, kt, vt, with_lse=True, **kw)
    got = fa_bwd.flash_attention_bwd_plain(qt, kt, vt, out, wt, lse, **kw)
    for g, x in zip(got, want):
        assert np.isfinite(x).all()
        np.testing.assert_allclose(g.numpy(), x, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_autograd_through_cpu_attention_matches_jax_grad(i):
    (q, k, v, w), kw, want_out, want = _case(i)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.attention(qt, kt, vt, impl="auto", **kw)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=2e-5,
                               rtol=2e-5)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(w))
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), x, atol=TOL, rtol=TOL)


BF16_TOL = 2e-2


def _mma_plain_case(i):
    """Case i in bf16 through the forward's plain version and
    ``flash_attention_bwd_mma_plain``, beside the reference's gradients
    and ``flash_attention_bwd_plain``'s on the same inputs."""
    (q, k, v, w), kw, _, want = _case(i, bf16=True)
    qt, kt, vt, wt = (torch.from_numpy(a).bfloat16() for a in (q, k, v, w))
    out, lse = fa.flash_attention_fwd(qt, kt, vt, with_lse=True, **kw)
    got = fa_bwd.flash_attention_bwd_mma_plain(qt, kt, vt, out, wt, lse,
                                               **kw)
    plain = fa_bwd.flash_attention_bwd_plain(qt, kt, vt, out, wt, lse, **kw)
    assert all(g.dtype == torch.bfloat16 for g in got)
    return got, want, plain


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_mma_plain_matches_jax_grad(i):
    got, want, _ = _mma_plain_case(i)
    err = max(float(np.abs(g.float().numpy() - x).max())
              for g, x in zip(got, want))
    print(f"mma plain vs jax.grad, case {IDS[i]}: max |err| {err:.3g}")
    for g, x in zip(got, want):
        assert np.isfinite(g.float().numpy()).all()
        np.testing.assert_allclose(g.float().numpy(), x, atol=BF16_TOL,
                                   rtol=BF16_TOL)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_mma_plain_matches_plain(i):
    got, _, plain = _mma_plain_case(i)
    err = max(float((g.float() - p.float()).abs().max())
              for g, p in zip(got, plain))
    print(f"mma plain vs plain, case {IDS[i]}: max |err| {err:.3g}")
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g.float().numpy(), p.float().numpy(),
                                   atol=BF16_TOL, rtol=BF16_TOL)


def test_lse_and_fully_masked_rows():
    """The plain forward's lse is the log-sum-exp of the masked scaled
    scores, -inf where a row sees no key; such a row's query gradient is
    exactly 0."""
    B, S, T, H, KV, D = 1, 40, 40, 2, 1, 64
    kw = dict(causal=True, q_offset=-5)
    q, k, v, w = _inputs(B, S, T, H, KV, D, seed=3)
    qt, kt, vt, wt = (torch.from_numpy(a) for a in (q, k, v, w))
    out, lse = fa.flash_attention_fwd(qt, kt, vt, with_lse=True, **kw)
    s = np.einsum("bshd,bthd->bhst", q * D ** -0.5,
                  np.repeat(k, H // KV, axis=2))
    mask = np.arange(T)[None, :] <= np.arange(S)[:, None] - 5
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf),
                                       axis=-1))
    assert np.isneginf(lse[:, :, :5].numpy()).all()
    np.testing.assert_allclose(lse[:, :, 5:].numpy(), want[:, :, 5:],
                               atol=1e-5, rtol=1e-5)
    dq, _, _ = fa_bwd.flash_attention_bwd_plain(qt, kt, vt, out, wt, lse,
                                                **kw)
    assert (dq[:, :5] == 0).all() and (out[:, :5] == 0).all()
    assert torch.isfinite(dq).all()


def test_no_gradient_is_the_forward_alone():
    """Without a gradient the call is the serving forward: the plain
    version's bits on the CPU, no autograd node."""
    q, k, v, _ = (torch.from_numpy(a) for a in
                  _inputs(1, 32, 32, 2, 1, 64, seed=4))
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None
    assert torch.equal(out, fa.flash_attention_plain(q, k, v))
    with torch.no_grad():
        out = fa.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None


def test_backward_on_other_devices_raises():
    # meta tensors take the accounting's meta path (the kernels' outputs,
    # no launch); tensors on two devices raise
    q = torch.empty((1, 8, 2, 64), device="meta")
    kv = q[:, :, :1]
    lse = torch.empty((1, 2, 8), device="meta")
    before = fa_bwd.launches
    dq, dk, dv = fa_bwd.flash_attention_bwd(q, kv, kv, q, q, lse)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, kv.shape, kv.shape)
    assert dq.device.type == "meta" and fa_bwd.launches == before
    with pytest.raises(ValueError, match="one device"):
        fa_bwd.flash_attention_bwd(q, kv, kv, q, q, torch.empty((1, 2, 8)))
