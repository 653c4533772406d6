"""The SSD chunk pass's gradient: the port's plain backward and its
autograd function against autograd and the JAX package.

* (a) ``ssd_scan_bwd.ssd_chunk_bwd_plain`` against ``torch.autograd`` of
  ``ssd_scan.ssd_chunked_plain`` (the forward kernel's arithmetic), with
  random cotangents on all three outputs (``y_intra``, ``states``,
  ``cum``): every gradient leaf within 1e-5 at float64 (the algebra),
  and at fp32 dx, ddt, dB and dC within 1e-5 of each leaf's largest
  entry; dA, one sum over B x S terms that cancel to a hundredth of
  their size, at fp32 within 1e-4 of the float64 value, where autograd's
  own fp32 dA lies up to 2e-5 off.
* (b) gradients of the port's ``ssd_chunked`` (through
  ``ssd_scan.SSDChunk`` on the CPU) with respect to x, dt, A, B, C and D
  against ``jax.grad`` of the reference's ``ref.ssd_chunked`` and
  ``ref.ssd`` (the quadratic oracle), fp32, a random output cotangent,
  at the reference's own gradient tolerance (1e-3,
  ``tests/test_kernels.py:100-118``), over the reference's SSD shapes
  (``tests/test_kernels.py:64-69``), a chunk equal to S and four
  chunks; with more than one chunk the backward receives nonzero
  cotangents of ``states`` and ``cum`` through the inter-chunk
  recurrence.
* (c) two calls of the forward and backward give equal bits with more
  than one intra-op thread.
* (d) the bf16 tensor-core kernel's rounding,
  ``ssd_scan_bwd.ssd_chunk_bwd_mma_plain``: the gradients of the port's
  ``ssd_chunked`` with bf16 x, B and C, its backward swapped for the
  rounding-aware version, against ``jax.grad`` of ``ref.ssd_chunked`` on
  the same bf16-representable values in fp32, each leaf within the bf16
  tolerance (5e-2) of its scale, over ``SHAPES`` and one case at
  mamba2-130m's width and chunk; and against ``ssd_chunk_bwd_plain`` on
  random cotangents of the three chunk outputs within half of it (the
  bound under which the kernel rounds dS to plain bf16), also at
  zamba2-2.7b's state width.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ssd_scan, ssd_scan_bwd  # noqa: E402

SHAPES = [(1, 64, 2, 64, 32, 32),          # tests/test_kernels.py:64-69
          (2, 128, 3, 64, 64, 32),
          (1, 128, 1, 32, 128, 64),
          (2, 64, 2, 32, 16, 64),          # chunk = S
          (1, 128, 2, 64, 16, 32)]         # four chunks
IDS = ["ref-a", "ref-b", "ref-c", "chunk-eq-S", "four-chunks"]


def _inputs(B, S, H, P, N, seed):
    """x, dt, A, B, C and D as numpy (the reference's test draws)."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.uniform(0.001, 0.1, (B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(H,)).astype(np.float32)]


def _plain_and_autograd(arrs, chunk, cts, dtype):
    ins = [torch.tensor(a, dtype=dtype, requires_grad=True)
           for a in arrs[:5]]
    outs = ssd_scan.ssd_chunked_plain(*ins, chunk=chunk)
    cts = [torch.tensor(c, dtype=dtype) for c in cts]
    auto = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(outs, cts)), ins)
    got = ssd_scan_bwd.ssd_chunk_bwd_plain(
        *[t.detach() for t in ins], outs[2].detach(), *cts, chunk=chunk)
    return got, auto


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES, ids=IDS)
def test_plain_backward_equals_autograd_of_the_plain_forward(B, S, H, P, N,
                                                             chunk):
    arrs = _inputs(B, S, H, P, N, seed=S + N)
    nc = S // chunk
    rng = np.random.default_rng(7)
    cts = [rng.normal(size=s) for s in ((B, H, nc, chunk, P),
                                        (B, H, nc, N, P), (B, H, nc, chunk))]
    got64, auto64 = _plain_and_autograd(arrs, chunk, cts, torch.float64)
    for g, w in zip(got64, auto64):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
    got, auto = _plain_and_autograd(arrs, chunk, cts, torch.float32)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, auto):
        assert g.dtype == torch.float32 and g.shape == w.shape
        if name == "dA":
            continue
        err = (g - w).abs().max().item()
        assert err <= 1e-5 * w.abs().max().item(), (name, err)
    truth = got64[2]
    scale = truth.abs().max().item()
    assert (got[2].double() - truth).abs().max().item() <= 1e-4 * scale
    assert (auto[2].double() - truth).abs().max().item() <= 1e-4 * scale


def _cotangent_probe(monkeypatch):
    """Record the norms of the cotangents ``SSDChunk.backward`` hands the
    backward kernel's wrapper."""
    seen = []
    real = ssd_scan_bwd.ssd_chunk_bwd

    def probe(x, dt, A, Bm, Cm, cum, dy, dstates, dcum, *, chunk):
        seen.append((dy.norm().item(), dstates[:, :, :-1].norm().item(),
                     dcum.norm().item()))
        return real(x, dt, A, Bm, Cm, cum, dy, dstates, dcum, chunk=chunk)
    monkeypatch.setattr(ssd_scan_bwd, "ssd_chunk_bwd", probe)
    return seen


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES, ids=IDS)
def test_ssd_chunked_gradients_match_the_reference(B, S, H, P, N, chunk,
                                                   monkeypatch):
    arrs = _inputs(B, S, H, P, N, seed=S + H)
    dy = np.random.default_rng(3).normal(size=(B, S, H, P)).astype(
        np.float32)
    ja = [jnp.asarray(a) for a in arrs]
    argnums = tuple(range(6))

    def jloss(fn):
        return lambda *a: (fn(*a) * jnp.asarray(dy)).sum()
    want_chunked = jax.jit(jax.grad(jloss(lambda *a: jref.ssd_chunked(
        *a, chunk=chunk)), argnums=argnums))(*ja)
    want_quad = jax.jit(jax.grad(jloss(jref.ssd), argnums=argnums))(*ja)

    seen = _cotangent_probe(monkeypatch)
    ins = [torch.tensor(a, requires_grad=True) for a in arrs]
    y = ssd_scan.ssd_chunked(*ins, chunk=chunk)
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    assert len(seen) == 1
    ndy, nds, ndc = seen[0]
    # one chunk: y_inter reads a zero state, so no cotangent reaches
    # states or cum
    assert ndy > 0 and ((nds > 0 and ndc > 0) or S == chunk)
    for name, g, wc, wq in zip(("x", "dt", "A", "B", "C", "D"), got,
                               want_chunked, want_quad):
        for w in (wc, wq):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3,
                                       rtol=1e-3, err_msg=name)


def test_forward_and_backward_bit_equal_across_calls_with_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(max(2, prev))
    try:
        assert torch.get_num_threads() >= 2
        arrs = _inputs(2, 128, 3, 64, 64, seed=11)
        dy = torch.from_numpy(np.random.default_rng(4).normal(
            size=(2, 128, 3, 64)).astype(np.float32))
        runs = []
        for _ in range(2):
            ins = [torch.tensor(a, requires_grad=True) for a in arrs]
            y = ssd_scan.ssd_chunked(*ins, chunk=32)
            runs.append([y.detach(), *torch.autograd.grad(y, ins, dy)])
        for a, b in zip(*runs):
            assert torch.equal(a, b)
    finally:
        torch.set_num_threads(prev)


# the bf16 tolerance of the SSD kernels, per leaf: max |err| <= tol (1 +
# max |want|) (tests/test_torch_cuda.py, chip_smoke.py)
BF16_TOL = 5e-2
MAMBA2_WIDTH = (1, 256, 2, 64, 128, 128)     # P 64, N 128, Q 128, 2 heads
ZAMBA2_WIDTH = (1, 256, 2, 64, 64, 128)      # N 64


def _bf16_values(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _leaf_close(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), (name, err)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES + [MAMBA2_WIDTH],
                         ids=IDS + ["mamba2-width"])
def test_mma_rounding_gradients_match_the_reference(B, S, H, P, N, chunk,
                                                    monkeypatch):
    arrs = _inputs(B, S, H, P, N, seed=S + H + 1)
    for i in (0, 3, 4):                       # x, B and C in bf16
        arrs[i] = _bf16_values(arrs[i])
    dy = _bf16_values(np.random.default_rng(5).normal(
        size=(B, S, H, P)).astype(np.float32))
    ja = [jnp.asarray(a) for a in arrs]
    want = jax.jit(jax.grad(lambda *a: (jref.ssd_chunked(
        *a, chunk=chunk) * jnp.asarray(dy)).sum(), argnums=tuple(range(6))))(
        *ja)
    monkeypatch.setattr(ssd_scan_bwd, "ssd_chunk_bwd",
                        lambda *a, chunk: ssd_scan_bwd.ssd_chunk_bwd_mma_plain(
                            *a, chunk=chunk))
    ins = [torch.tensor(a, requires_grad=True) for a in arrs]
    for i in (0, 3, 4):
        ins[i] = torch.tensor(arrs[i], dtype=torch.bfloat16,
                              requires_grad=True)
    y = ssd_scan.ssd_chunked(*ins, chunk=chunk)
    assert y.dtype == torch.bfloat16
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy).bfloat16())
    for name, g, w, t in zip(("x", "dt", "A", "B", "C", "D"), got, want,
                             ins):
        assert g.dtype == t.dtype, name
        _leaf_close(g.float().numpy(), w, BF16_TOL, name)


@pytest.mark.parametrize("B,S,H,P,N,chunk",
                         SHAPES + [MAMBA2_WIDTH, ZAMBA2_WIDTH],
                         ids=IDS + ["mamba2-width", "zamba2-width"])
def test_mma_rounding_matches_the_plain_backward(B, S, H, P, N, chunk):
    arrs = _inputs(B, S, H, P, N, seed=S + N + 2)
    x, dt, A, Bm, Cm = [torch.from_numpy(a) for a in arrs[:5]]
    x, Bm, Cm = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    _, _, cum = ssd_scan.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=chunk)
    nc = S // chunk
    rng = np.random.default_rng(9)
    cts = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
           for s in ((B, H, nc, chunk, P), (B, H, nc, N, P),
                     (B, H, nc, chunk))]
    ins = (x, dt, A, Bm, Cm, cum, *cts)
    got = ssd_scan_bwd.ssd_chunk_bwd_mma_plain(*ins, chunk=chunk)
    want = ssd_scan_bwd.ssd_chunk_bwd_plain(*ins, chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _leaf_close(g.float().numpy(), w.float().numpy(), BF16_TOL / 2, name)
