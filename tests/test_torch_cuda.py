"""The port's CUDA kernels on the card, against their plain versions.

These imports hold no JAX, so the file also runs on a machine with a GPU
and no JAX: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``. Elsewhere every test skips: a CUDA kernel
has no CPU mode (its arithmetic is held against the reference on the CPU
through ``flash_attention_plain``, in ``tests/test_torch_kernels.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import attention as fa  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, S, T, H, KV, D, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype).cuda()
            for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KV,D,kw", [
    (1, 128, 128, 4, 4, 64, {}),
    (2, 256, 256, 4, 2, 64, {}),
    (1, 128, 128, 4, 1, 128, {}),
    (1, 96, 96, 2, 2, 80, {}),
    (1, 256, 256, 2, 2, 64, {"window": 17}),
    (2, 1, 200, 4, 2, 64, {"q_offset": 199}),
    (1, 40, 40, 2, 1, 64, {"q_offset": -5}),          # fully masked rows
    (2, 70, 300, 3, 1, 64, {"causal": False}),
])
def test_kernel_matches_plain(cuda, dtype, B, S, T, H, KV, D, kw):
    q, k, v = _qkv(B, S, T, H, KV, D, dtype, seed=S + T)
    kw = {"causal": True, **kw}
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_kernel_reads_strided_inputs(cuda):
    """q/k/v as slices of one fused projection: read through the strides."""
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((2, 64, 4 + 2 + 2, 64), generator=g).cuda()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case,err", [
    ("float16", TypeError), ("head_dim_96", ValueError),
    ("last_dim_strided", ValueError)])
def test_kernel_refuses_what_it_does_not_take(cuda, case, err):
    q, k, v = _qkv(1, 16, 16, 2, 1, 64, torch.float32, seed=1)
    if case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "head_dim_96":
        q, k, v = (torch.zeros(t.shape[:3] + (96,), device="cuda")
                   for t in (q, k, v))
    else:
        q = torch.zeros((1, 16, 2, 128), device="cuda")[..., ::2]
    before = fa.launches
    with pytest.raises(err):
        fa.flash_attention(q, k, v)
    assert fa.launches == before
