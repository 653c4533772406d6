"""The port's CUDA kernels on the card, against their plain versions.

These imports hold no JAX, so the file also runs on a machine with a GPU
and no JAX: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``. Elsewhere every test skips: a CUDA kernel
has no CPU mode (its arithmetic is held against the reference on the CPU
through ``flash_attention_plain``, ``flash_attention_bwd_plain``,
``ssd_chunked_plain``, ``segment_combine_plain`` and
``paged_attention_split_plain``, in ``tests/test_torch_kernels.py``,
``tests/test_torch_attention_grad.py``, ``tests/test_torch_ssm.py``,
``tests/test_torch_collectives.py`` and
``tests/test_torch_paged_attention.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import attention_bwd as fa_bwd  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import segment_reduce  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels import ssd_scan_bwd  # noqa: E402

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
    # the edges of the bf16 tensor-core kernel at each head dim
    (2, 200, 200, 4, 1, 128, {}),                     # MQA, S = 200
    (2, 200, 200, 6, 2, 80, {}),                      # GQA
    (1, 96, 300, 4, 2, 64, {"q_offset": 204}),        # T > S, q_offset
    (1, 200, 264, 2, 1, 128, {"q_offset": 64, "window": 64}),
    (1, 256, 256, 2, 2, 64, {"window": 1}),
    (1, 256, 256, 2, 2, 80, {"window": 17}),
    (1, 256, 256, 2, 2, 128, {"window": 64}),
    (1, 64, 64, 2, 1, 64, {"q_offset": 50, "window": 16}),  # rows 29+ masked
    (1, 40, 40, 2, 1, 80, {"q_offset": -5}),
    (2, 70, 300, 3, 1, 128, {"causal": False}),
    # the grouped configurations' query groups at D 128, more than one kv
    # head: glm4-9b / chatglm3-6b (32/2, 16), qwen2.5-3b (16/2, 8),
    # arctic-480b (56/8, 7)
    (1, 200, 200, 32, 2, 128, {}),
    (2, 128, 128, 16, 2, 128, {}),
    (1, 200, 264, 56, 8, 128, {"q_offset": 64}),
])
def test_kernel_matches_plain(cuda, dtype, B, S, T, H, KV, D, kw):
    q, k, v = _qkv(B, S, T, H, KV, D, dtype, seed=S + T)
    kw = {"causal": True, **kw}
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert fa.last_kernel() == (f"fa_fwd_mma<bf16,{D}>"
                                if dtype == torch.bfloat16
                                else f"fa_fwd<f32,{D}>")
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    # a query that sees no key gives 0 (its plain row is exactly 0)
    masked = want.float().abs().amax(dim=(0, 2, 3)) == 0
    assert (got[:, masked] == 0).all()


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


def test_bf16_kernel_reads_views_of_a_fused_projection(cuda):
    g = torch.Generator().manual_seed(2)
    qkv = torch.randn((2, 96, 4 + 2 + 2, 80), generator=g).bfloat16().cuda()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = fa.flash_attention(q, k, v, causal=True, window=40)
    assert fa.last_kernel() == "fa_fwd_mma<bf16,80>"
    want = fa.flash_attention_plain(q, k, v, causal=True, window=40)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("case", ["q_head_stride", "k_base_offset"])
def test_bf16_kernel_refuses_misaligned_rows_and_never_falls_back(cuda, case):
    """A row that does not start on a 16-byte boundary raises; neither the
    SIMT kernel nor the plain version takes the call instead."""
    q, k, v = _qkv(1, 32, 32, 2, 1, 64, torch.bfloat16, seed=3)
    if case == "q_head_stride":      # 68 elements between heads
        q = torch.zeros((1, 32, 2, 68), dtype=torch.bfloat16,
                        device="cuda")[..., :64]
    else:                            # every row 2 bytes off
        k = torch.zeros((1 * 32 * 64 + 1,), dtype=torch.bfloat16,
                        device="cuda")[1:].reshape(1, 32, 1, 64)
    fa.flash_attention(*_qkv(1, 16, 16, 2, 1, 64, torch.float32, seed=4))
    before, ran = fa.launches, fa.last_kernel()
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fa.flash_attention(q, k, v)
    assert fa.launches == before and fa.last_kernel() == ran


# ---------------------------------------------------------------------------
# flash attention for training: the row log-sum-exp and the backward kernel
# ---------------------------------------------------------------------------
# f32: the kernel sums up to S x H/KV terms per dK/dV entry in another
# order than the plain version; bf16: both compute in fp32 from the same
# bf16 inputs and round once, so they differ by that order and one
# rounding of the result (the forward's bf16 tolerance)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 against flash_attention_bwd_mma_plain, which rounds P and dS where
# the tensor-core kernels do and sums the GQA partials in the same order:
# what is left is the fp32 summation order inside the products, which
# now and then moves a rounded P or dS by one bf16 ulp, and the final
# rounding, one bf16 ulp of the output (2**-7 relative)
BWD_MMA_TOL = 1e-2
BWD_CASES = [
    (1, 128, 128, 4, 4, 64, {}),
    (2, 256, 256, 9, 3, 64, {}),                      # smollm's heads
    (1, 128, 128, 4, 1, 128, {}),                     # MQA
    (1, 96, 96, 2, 2, 80, {}),
    (2, 200, 200, 6, 2, 80, {}),                      # GQA, S = 200
    (1, 256, 256, 2, 2, 64, {"window": 17}),
    (1, 256, 256, 2, 2, 128, {"window": 64}),
    (1, 40, 40, 2, 1, 64, {"q_offset": -5}),          # fully masked rows
    (1, 64, 64, 2, 1, 64, {"q_offset": 50, "window": 16}),
    (2, 70, 300, 3, 1, 128, {"causal": False}),       # T != S, key padding
    (1, 96, 300, 4, 2, 64, {"q_offset": 204}),
    # S and T off the tile heights (32 and 64 rows); D 80 and 128 with
    # query groups of 1, 2 and 3
    (2, 200, 264, 6, 3, 64, {"q_offset": 64}),
    (1, 200, 264, 3, 3, 80, {"q_offset": 64}),
    (2, 200, 264, 4, 2, 80, {"q_offset": 64}),
    (2, 200, 264, 4, 2, 128, {}),
    (1, 200, 264, 6, 2, 128, {"q_offset": 64, "window": 96}),
    (2, 256, 256, 16, 16, 128, {}),   # olmoe-1b-7b's heads (16/16 of 128)
    # groups of 16, 8 and 7 over more than one kv head: the last block of
    # each kv head sums its group's fp32 partials in head order
    (1, 256, 256, 32, 2, 128, {}),    # glm4-9b / chatglm3-6b
    (2, 128, 128, 8, 1, 128, {}),     # qwen2.5-3b's heads a rank, model 2
    (2, 200, 200, 16, 2, 128, {}),    # qwen2.5-3b
    (1, 200, 264, 56, 8, 128, {"q_offset": 64}),  # arctic-480b
]


def _bwd_name(dtype, D):
    """The instantiation the wrapper must run: bf16 on the tensor cores,
    fp32 on the SIMT kernels."""
    return (f"fa_bwd_mma<bf16,{D}>" if dtype == torch.bfloat16
            else f"fa_bwd<f32,{D}>")


def _bwd_inputs(B, S, T, H, KV, D, dtype, kw, seed):
    q, k, v = _qkv(B, S, T, H, KV, D, dtype, seed)
    out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    g = torch.Generator().manual_seed(seed + 1)
    dout = torch.randn(q.shape, generator=g).to(dtype).cuda()
    return q, k, v, out, dout, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KV,D,kw", BWD_CASES)
def test_backward_kernel_matches_plain(cuda, dtype, B, S, T, H, KV, D, kw):
    kw = {"causal": True, **kw}
    args = _bwd_inputs(B, S, T, H, KV, D, dtype, kw, seed=S + T)
    before = fa_bwd.launches
    got = fa_bwd.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert fa_bwd.launches == before + fa_bwd.LAUNCHES_PER_CALL
    assert fa_bwd.last_kernel() == _bwd_name(dtype, D)
    want = fa_bwd.flash_attention_bwd_plain(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), w.float(), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype])
    if dtype == torch.bfloat16:
        mma = fa_bwd.flash_attention_bwd_mma_plain(*args, **kw)
        for g, w in zip(got, mma):
            torch.testing.assert_close(g.float(), w.float(),
                                       atol=BWD_MMA_TOL, rtol=BWD_MMA_TOL)
    # deterministic: a second call gives the same bits
    again = fa_bwd.flash_attention_bwd(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KV,D,kw", BWD_CASES)
def test_forward_lse_matches_plain(cuda, dtype, B, S, T, H, KV, D, kw):
    kw = {"causal": True, **kw}
    q, k, v = _qkv(B, S, T, H, KV, D, dtype, seed=S + T)
    out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    _, want = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    # a row that sees no key is -inf in both; the others agree to fp32
    # summation order
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(lse[fin], want[fin], atol=1e-4, rtol=1e-5)
    # the serving forward writes the same output bits without lse
    serving = fa.flash_attention(q, k, v, **kw)
    assert torch.equal(serving, out)


# the enc-dec and VLM families' prefill attention: whisper's encoder
# (non-causal over 1500 frames, a 28-key last tile; D = 64, no grouping;
# 4 of its 20 heads) and llava's patch prefix with text (causal over
# 2880 + 128 rows, D = 128, GQA 4; 8 of its 32 query heads)
MODEL_PREFILL_CASES = [
    (2, 1500, 1500, 4, 4, 64, {"causal": False}),
    (1, 3008, 3008, 8, 2, 128, {}),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KV,D,kw", MODEL_PREFILL_CASES)
def test_model_prefill_shapes_forward_and_backward(cuda, dtype, B, S, T, H,
                                                   KV, D, kw):
    """The forward (with its lse) and the backward at the enc-dec and VLM
    prefill shapes against their plain versions, at the sweep's
    tolerances; the bf16 backward also against its rounding."""
    kw = {"causal": True, **kw}
    q, k, v = _qkv(B, S, T, H, KV, D, dtype, seed=S + H)
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    args = _bwd_inputs(B, S, T, H, KV, D, dtype, kw, seed=S + H)
    assert torch.equal(args[3], got)
    grads = fa_bwd.flash_attention_bwd(*args, **kw)
    assert fa_bwd.last_kernel() == _bwd_name(dtype, D)
    for g, w in zip(grads, fa_bwd.flash_attention_bwd_plain(*args, **kw)):
        assert g.dtype == dtype and torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), w.float(), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype])
    if dtype == torch.bfloat16:
        mma = fa_bwd.flash_attention_bwd_mma_plain(*args, **kw)
        for g, w in zip(grads, mma):
            torch.testing.assert_close(g.float(), w.float(),
                                       atol=BWD_MMA_TOL, rtol=BWD_MMA_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_runs_both_kernels(cuda, dtype):
    """A CUDA input that requires a gradient runs the forward kernel once
    and the backward kernels once per backward, with the backward's
    gradients; a strided output gradient is read as it is."""
    kw = dict(causal=True)
    q, k, v = (t.requires_grad_() for t in
               _qkv(2, 256, 256, 9, 3, 64, dtype, seed=11))
    f0, b0 = fa.launches, fa_bwd.launches
    out = fa.flash_attention(q, k, v, **kw)
    g = torch.Generator().manual_seed(12)
    dout = torch.randn((2, 256, 64, 9), generator=g).to(dtype).cuda()
    dout = dout.transpose(2, 3)               # strided, last dim not unit
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    assert fa.launches == f0 + 1
    assert fa_bwd.launches == b0 + fa_bwd.LAUNCHES_PER_CALL
    assert fa_bwd.last_kernel() == _bwd_name(dtype, 64)
    o, lse = fa.flash_attention_fwd(q.detach(), k.detach(), v.detach(),
                                    with_lse=True, **kw)
    want = fa_bwd.flash_attention_bwd_plain(q.detach(), k.detach(),
                                            v.detach(), o, dout, lse, **kw)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got.float(), w.float(),
                                   atol=BWD_TOL[dtype], rtol=BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,tp", [(4, 1, 2), (12, 3, 2)])
def test_tensor_parallel_mixed_heads_through_both_kernels(cuda, dtype, H,
                                                          KV, tp):
    """One tensor-parallel rank's attention where the query heads split
    over the model axis and the kv heads do not (reduced smollm's 4 over
    1; 12 over 3, whose rank reads one kv head per query head): each
    rank's H/tp heads and the kv heads they read (`layers._kv_index`)
    through the forward and backward kernels, against the plain version
    under autograd on the same slices; the ranks' outputs summed are the
    whole block's."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import layers as L
    B, S, d, D = 2, 256, 128, 64
    cfg = ModelConfig(name="mixed", family="dense", num_layers=1,
                      d_model=d, num_heads=H, num_kv_heads=KV, head_dim=D,
                      d_ff=256, vocab_size=256)
    g = torch.Generator().manual_seed(H)
    x = torch.randn((B, S, d), generator=g).to(dtype).cuda()
    w = {n: (torch.randn((d, h, D), generator=g) * d ** -0.5).to(dtype)
         .cuda() for n, h in (("wq", H), ("wk", KV), ("wv", KV))}
    whole = fa.flash_attention_plain(*(
        torch.einsum("bsd,dhk->bshk", x, w[n]) for n in ("wq", "wk", "wv")),
        causal=True)
    hl = H // tp
    parts = []
    for m in range(tp):
        idx = L._kv_index(cfg, hl, m)
        leaves = [t.clone().requires_grad_() for t in (
            x, w["wq"][:, m * hl:(m + 1) * hl], w["wk"], w["wv"])]

        def run(attend):
            xx, wq, wk, wv = leaves
            q = torch.einsum("bsd,dhk->bshk", xx, wq)
            k = torch.einsum("bsd,dhk->bshk", xx, wk[:, idx])
            v = torch.einsum("bsd,dhk->bshk", xx, wv[:, idx])
            out = attend(q, k, v, causal=True)
            dout = torch.randn(out.shape, generator=torch.Generator()
                               .manual_seed(m)).to(dtype).cuda()
            return out, torch.autograd.grad(out, leaves, dout)
        f0, b0 = fa.launches, fa_bwd.launches
        got, got_g = run(fa.flash_attention)
        assert fa.launches == f0 + 1
        assert fa_bwd.launches == b0 + fa_bwd.LAUNCHES_PER_CALL
        want, want_g = run(fa.flash_attention_plain)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        for a, b in zip(got_g, want_g):
            assert torch.isfinite(a).all()
            scale = b.float().abs().max().item()
            assert (a.float() - b.float()).abs().max().item() <= \
                BWD_TOL[dtype] * max(scale, 1.0)
        parts.append(got.float())
    torch.testing.assert_close(torch.cat(parts, dim=2), whole.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("case", ["k_offset_2_bytes", "dout_row_stride_68",
                                  "q_and_out_offset_2_bytes"])
def test_backward_copies_rows_off_16_bytes(cuda, case):
    """The tensor-core kernels read 16-byte rows: a bf16 tensor whose rows
    do not start on 16 bytes is copied first (autograd may hand over such
    an output gradient), and the call gives the bits of the aligned call
    on the same values, through the same kernels."""
    kw = dict(causal=True)
    args = list(_bwd_inputs(1, 64, 64, 4, 2, 64, torch.bfloat16, kw,
                            seed=13))
    want = fa_bwd.flash_attention_bwd(*args, **kw)

    def off(t, extra):                 # the same values, rows moved
        if extra == 0:                 # by one element
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
            return buf[1:].view(t.shape).copy_(t)
        pad = torch.zeros(t.shape[:3] + (t.shape[3] + extra,),
                          dtype=t.dtype, device="cuda")
        return pad[..., :t.shape[3]].copy_(t)
    if case == "k_offset_2_bytes":
        args[1] = off(args[1], 0)
    elif case == "dout_row_stride_68":
        args[4] = off(args[4], 4)
    else:
        args[0], args[3] = off(args[0], 0), off(args[3], 0)
    before = fa_bwd.launches
    got = fa_bwd.flash_attention_bwd(*args, **kw)
    assert fa_bwd.launches == before + fa_bwd.LAUNCHES_PER_CALL
    assert fa_bwd.last_kernel() == "fa_bwd_mma<bf16,64>"
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case,err", [
    ("float16", TypeError), ("head_dim_96", ValueError),
    ("lse_shape", ValueError)])
def test_backward_refuses_what_it_does_not_take(cuda, case, err):
    kw = dict(causal=True)
    q, k, v, out, dout, lse = _bwd_inputs(1, 32, 32, 2, 1, 64,
                                          torch.float32, kw, seed=6)
    if case == "float16":
        q, k, v, out, dout = (t.half() for t in (q, k, v, out, dout))
    elif case == "head_dim_96":
        q, out, dout = (torch.zeros((1, 32, 2, 96), device="cuda")
                        for _ in range(3))
        k = v = torch.zeros((1, 32, 1, 96), device="cuda")
    else:
        lse = lse[:, :, :16]
    before = fa_bwd.launches
    with pytest.raises(err):
        fa_bwd.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert fa_bwd.launches == before


# ---------------------------------------------------------------------------
# the SSD within-chunk kernel
# ---------------------------------------------------------------------------
SSD_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}


def _ssd_inputs(B, S, H, P, N, dtype, seed):
    """x, B and C as column slices of one (B, S, H*P + 2N) tensor, as the
    model hands them over, so the kernel reads them through strides."""
    g = torch.Generator().manual_seed(seed)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=g).to(dtype).cuda()
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = (0.001 + 0.099 * torch.rand((B, S, H), generator=g)).cuda()
    A = -(0.5 + 1.5 * torch.rand((H,), generator=g)).cuda()
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 128, 3, 64, 64, 32),
    (1, 200, 2, 64, 128, 100),          # Q not a power of two
    (1, 128, 1, 32, 16, 128),           # N below one staged slice
    # mamba2's continuous path: one request of 128, 256 and 512 tokens
    (1, 128, 24, 64, 128, 128),
    (1, 256, 24, 64, 128, 128),
    (1, 512, 24, 64, 128, 128),
    (2, 14, 3, 32, 64, 7),              # Q = 7: one live warp of rows
    (4, 512, 80, 64, 64, 128),          # zamba2 serving
])
def test_ssd_kernel_matches_plain(cuda, dtype, B, S, H, P, N, chunk):
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, dtype, seed=S + N)
    assert x.stride(-1) == 1 and not x.is_contiguous()
    before = ssd_scan.launches
    got = ssd_scan.ssd_chunk(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert ssd_scan.last_kernel() == (f"ssd_chunk_mma<bf16,{P}>"
                                      if dtype == torch.bfloat16
                                      else f"ssd_chunk<f32,{P}>")
    want = ssd_scan.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=SSD_TOL[dtype],
                                   rtol=SSD_TOL[dtype])


@pytest.mark.parametrize("case,err", [
    ("float16", TypeError), ("head_dim_48", ValueError),
    ("chunk_129", ValueError), ("ragged_chunk", ValueError),
    ("bf16_state_136", ValueError), ("bf16_misaligned_rows", ValueError)])
def test_ssd_kernel_refuses_what_it_does_not_take(cuda, case, err):
    x, dt, A, Bm, Cm = _ssd_inputs(1, 258, 2, 64, 16, torch.float32, seed=1)
    chunk = 129 if case == "chunk_129" else 43
    if case == "float16":
        x, Bm, Cm = x.half(), Bm.half(), Cm.half()
    elif case == "head_dim_48":
        x = torch.zeros((1, 258, 2, 48), device="cuda")
    elif case == "ragged_chunk":
        chunk = 100
    elif case == "bf16_state_136":       # more state dims than the tile
        x, dt, A, Bm, Cm = _ssd_inputs(1, 258, 2, 64, 136, torch.bfloat16,
                                       seed=1)
    elif case == "bf16_misaligned_rows":  # x rows 2 bytes off 16
        x, Bm, Cm = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
        x = torch.zeros((1, 258, 2 * 64 + 1), dtype=torch.bfloat16,
                        device="cuda")[..., 1:].reshape(1, 258, 2, 64)
    before = ssd_scan.launches
    with pytest.raises(err):
        ssd_scan.ssd_chunk(x, dt, A, Bm, Cm, chunk=chunk)
    assert ssd_scan.launches == before


# ---------------------------------------------------------------------------
# the SSD chunk backward kernel
# ---------------------------------------------------------------------------
def _ssd_cotangents(x, dt, A, Bm, Cm, chunk, seed):
    """The forward kernel's outputs and random fp32 cotangents of all
    three, so every term of the backward is exercised."""
    y, states, cum = ssd_scan.ssd_chunk(x, dt, A, Bm, Cm, chunk=chunk)
    g = torch.Generator().manual_seed(seed)
    return cum, [torch.randn(t.shape, generator=g).cuda()
                 for t in (y, states, cum)]


def _ssd_bwd_close(got, want, tol):
    """Per gradient leaf, max |got - want| <= tol (1 + max |want|): dt's
    and A's gradients are sums whose terms cancel (the reverse cumsum of
    dcum), so their fp32 error scales with the leaf's largest entry, not
    with each entry."""
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * (1 + w.float().abs().max().item()), (name, err)


SSD_BWD_SWEEP = [
    (1, 64, 2, 64, 32, 32),             # tests/test_kernels.py's sweep
    (2, 128, 3, 64, 64, 32),
    (1, 128, 1, 32, 128, 64),
    (1, 200, 2, 64, 128, 100),          # Q not a power of two
    (2, 14, 3, 32, 16, 7),              # Q = 7, N below one slice
    (2, 256, 24, 64, 128, 128),         # mamba2-130m training, per rank
    (2, 256, 80, 64, 64, 128),          # zamba2-2.7b
]
# the bf16 tensor-core kernel against ssd_chunk_bwd_mma_plain, which rounds
# dy, dS, the scores and dG where the kernel does and sums the heads in the
# clusters' order: what is left is the fp32 summation order inside the
# products, which now and then moves a rounded score or dG by one bf16 ulp,
# and the final rounding of dx, dB and dC, one bf16 ulp (2**-8 relative)
SSD_BWD_MMA_TOL = 1e-2


def _ssd_bwd_call(B, S, H, P, N, chunk, dtype):
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, dtype, seed=S + H)
    cum, cts = _ssd_cotangents(x, dt, A, Bm, Cm, chunk, seed=S + N)
    return (x, dt, A, Bm, Cm, cum, *cts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_BWD_SWEEP)
def test_ssd_backward_kernel_matches_plain(cuda, dtype, B, S, H, P, N,
                                          chunk):
    ins = _ssd_bwd_call(B, S, H, P, N, chunk, dtype)
    before = ssd_scan_bwd.launches
    got = ssd_scan_bwd.ssd_chunk_bwd(*ins, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan_bwd.launches == \
        before + ssd_scan_bwd.LAUNCHES_PER_CALL[dtype]
    assert ssd_scan_bwd.last_kernel() == (
        f"ssd_chunk_bwd_mma<bf16,{P}>" if dtype == torch.bfloat16
        else f"ssd_chunk_bwd<f32,{P}>")
    want = ssd_scan_bwd.ssd_chunk_bwd_plain(*ins, chunk=chunk)
    _ssd_bwd_close(got, want, SSD_TOL[dtype])
    again = ssd_scan_bwd.ssd_chunk_bwd(*ins, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_BWD_SWEEP)
def test_ssd_backward_mma_matches_its_rounding(cuda, B, S, H, P, N, chunk):
    ins = _ssd_bwd_call(B, S, H, P, N, chunk, torch.bfloat16)
    got = ssd_scan_bwd.ssd_chunk_bwd(*ins, chunk=chunk)
    want = ssd_scan_bwd.ssd_chunk_bwd_mma_plain(*ins, chunk=chunk)
    _ssd_bwd_close(got, want, SSD_BWD_MMA_TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 128, 3, 64, 64, 32), (2, 256, 24, 64, 128, 128)])
def test_ssd_backward_simt_still_runs(cuda, B, S, H, P, N, chunk):
    """``simt=True`` runs the first design's SIMT pair on bf16 (the
    yardstick ``chip_smoke.py`` times), two launches, within the bf16
    tolerance of the plain version."""
    ins = _ssd_bwd_call(B, S, H, P, N, chunk, torch.bfloat16)
    before = ssd_scan_bwd.launches
    got = ssd_scan_bwd.ssd_chunk_bwd(*ins, chunk=chunk, simt=True)
    torch.cuda.synchronize()
    assert ssd_scan_bwd.launches == \
        before + ssd_scan_bwd.LAUNCHES_PER_CALL[torch.float32]
    assert ssd_scan_bwd.last_kernel() == f"ssd_chunk_bwd<bf16,{P}>"
    want = ssd_scan_bwd.ssd_chunk_bwd_plain(*ins, chunk=chunk)
    _ssd_bwd_close(got, want, SSD_TOL[torch.bfloat16])


def test_ssd_backward_bf16_is_one_kernel(cuda):
    """One bf16 call launches LAUNCHES_PER_CALL kernels on the device and
    nothing else: no copy of a cotangent, no cast of an output."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ins = _ssd_bwd_call(2, 256, 24, 64, 128, 128, torch.bfloat16)
    ssd_scan_bwd.ssd_chunk_bwd(*ins, chunk=128)      # the counters exist
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ssd_scan_bwd.ssd_chunk_bwd(*ins, chunk=128)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == ssd_scan_bwd.LAUNCHES_PER_CALL[torch.bfloat16], \
        names
    assert "ssd_chunk_bwd_mma" in names[0]


def test_ssd_backward_reads_strided_dy(cuda):
    """The training path hands dy over as a transposed view; the kernel
    reads it through its strides, bit for bit as a contiguous copy."""
    B, S, H, P, N, chunk = 2, 256, 24, 64, 128, 128
    x, dt, A, Bm, Cm, cum, dy, ds, dc = _ssd_bwd_call(B, S, H, P, N, chunk,
                                                      torch.bfloat16)
    nc = S // chunk
    view = dy.permute(0, 2, 3, 1, 4).contiguous().permute(0, 3, 1, 2, 4)
    assert torch.equal(view, dy) and not view.is_contiguous()
    got = ssd_scan_bwd.ssd_chunk_bwd(x, dt, A, Bm, Cm, cum, view, ds, dc,
                                     chunk=chunk)
    want = ssd_scan_bwd.ssd_chunk_bwd(x, dt, A, Bm, Cm, cum, dy, ds, dc,
                                      chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert view.shape == (B, H, nc, chunk, P)


def test_ssd_backward_calls_on_two_streams_at_once(cuda):
    """Calls in flight on two streams at once keep their own arrival
    counters: each gives the bits of the same call made alone, within
    the kernel's tolerance of its rounding, and the calls after them on
    the default stream still do."""
    shapes = [(2, 256, 24, 64, 128, 128), (2, 128, 3, 64, 64, 32)]
    ins = [_ssd_bwd_call(*shape, torch.bfloat16) for shape in shapes]
    alone = [ssd_scan_bwd.ssd_chunk_bwd(*a, chunk=s[-1])
             for a, s in zip(ins, shapes)]
    streams = [torch.cuda.Stream() for _ in shapes]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(8):
        for i, (a, s, shape) in enumerate(zip(ins, streams, shapes)):
            with torch.cuda.stream(s):
                got[i].append(ssd_scan_bwd.ssd_chunk_bwd(*a, chunk=shape[-1]))
    torch.cuda.synchronize()
    for i, shape in enumerate(shapes):
        for out in got[i]:
            assert all(torch.equal(a, b) for a, b in zip(out, alone[i])), \
                shape
        want = ssd_scan_bwd.ssd_chunk_bwd_mma_plain(*ins[i], chunk=shape[-1])
        _ssd_bwd_close(alone[i], want, SSD_BWD_MMA_TOL)
        after = ssd_scan_bwd.ssd_chunk_bwd(*ins[i], chunk=shape[-1])
        assert all(torch.equal(a, b) for a, b in zip(after, alone[i]))


@pytest.mark.parametrize("case", ["state_136", "state_20",
                                  "misaligned_rows"])
def test_ssd_backward_mma_refuses_what_it_does_not_take(cuda, case):
    N = {"state_136": 136, "state_20": 20}.get(case, 16)
    # cum from the fp32 forward: the bf16 one refuses these N as well
    x, dt, A, Bm, Cm, cum, *cts = _ssd_bwd_call(1, 64, 2, 64, N, 32,
                                                torch.float32)
    x, Bm, Cm = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    if case == "misaligned_rows":        # x rows 2 bytes off 16
        x = torch.zeros((1, 64, 2 * 64 + 1), dtype=torch.bfloat16,
                        device="cuda")[..., 1:].reshape(1, 64, 2, 64)
    before = ssd_scan_bwd.launches
    with pytest.raises(ValueError):
        ssd_scan_bwd.ssd_chunk_bwd(x, dt, A, Bm, Cm, cum, *cts, chunk=32)
    assert ssd_scan_bwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_autograd_runs_both_kernels(cuda, dtype):
    """A CUDA input that requires a gradient runs the SSD forward kernel
    once and the backward kernels once per backward (``ops.ssd``,
    ``impl="auto"``); the gradients of the fused x/B/C projection, dt, A
    and D equal plain autograd's through the chunked oracle
    (``impl="xla"``, no launch) within the kernels' tolerance."""
    from repro_torch.kernels import ops
    H, P, N = 4, 64, 64
    x, dt, A, Bm, Cm = _ssd_inputs(2, 256, H, P, N, dtype, seed=7)
    xbc = torch.cat([x.reshape(2, 256, -1), Bm, Cm], -1)
    D = torch.linspace(0.5, 1.5, H, device="cuda")
    g = torch.Generator().manual_seed(8)
    dy = torch.randn((2, 256, H, P), generator=g).to(dtype).cuda()
    grads = {}
    for impl in ("auto", "xla"):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (xbc, dt, A, D)]
        f = leaves[0]
        f0, b0 = ssd_scan.launches, ssd_scan_bwd.launches
        y = ops.ssd(f[..., :H * P].reshape(2, 256, H, P), leaves[1],
                    leaves[2], f[..., H * P:H * P + N], f[..., H * P + N:],
                    leaves[3], chunk=128, impl=impl)
        grads[impl] = torch.autograd.grad(y, leaves, dy)
        n = 1 if impl == "auto" else 0
        assert ssd_scan.launches == f0 + n
        assert ssd_scan_bwd.launches == \
            b0 + n * ssd_scan_bwd.LAUNCHES_PER_CALL[dtype]
    for a, b in zip(grads["auto"], grads["xla"]):
        assert a.dtype == b.dtype and torch.isfinite(a).all()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= SSD_TOL[dtype] * (1 + b.float().abs().max().item())


# ---------------------------------------------------------------------------
# the segment-combine kernel and a collective on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("n,offset", [
    (7, 0), (128, 0), (1000, 0), (65536, 0),      # the reference's sweep
    (4099, 0),                                    # vector body + scalar tail
    (1000, 1), (65536, 3), (4099, 5),             # misaligned: scalar loop
    (1 << 20, 2),
])
def test_segment_combine_matches_plain(cuda, dtype, op, n, offset):
    g = torch.Generator().manual_seed(n + offset)
    acc = torch.randn((n + offset,), generator=g).to(dtype).cuda()[offset:]
    part = torch.randn((n,), generator=g).to(dtype).cuda()
    before = segment_reduce.launches
    got = segment_reduce.segment_combine(acc, part, op)
    torch.cuda.synchronize()
    assert segment_reduce.launches == before + 1
    want = segment_reduce.segment_combine_plain(acc, part, op)
    assert got.dtype == dtype and torch.equal(got, want)
    # in place into acc: the out-of-place bits, one more launch
    res = segment_reduce.segment_combine(acc, part, op, out=acc)
    torch.cuda.synchronize()
    assert segment_reduce.launches == before + 2
    assert res.data_ptr() == acc.data_ptr() and torch.equal(acc, want)


def test_segment_combine_propagates_nan(cuda):
    acc = torch.tensor([float("nan"), 1.0, 2.0, float("nan")], device="cuda")
    part = torch.tensor([1.0, float("nan"), 3.0, float("nan")], device="cuda")
    for op in ("add", "max", "min"):
        got = segment_reduce.segment_combine(acc, part, op)
        want = segment_reduce.segment_combine_plain(acc, part, op)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got[2:3], want[2:3])
        in_place = acc.clone()
        segment_reduce.segment_combine(in_place, part, op, out=in_place)
        assert torch.equal(in_place.isnan(), want.isnan())
        assert torch.equal(in_place[2:3], want[2:3])


@pytest.mark.parametrize("case,err", [
    ("float16", TypeError), ("strided", ValueError), ("op", ValueError),
    ("shape", ValueError)])
def test_segment_combine_refuses_what_it_does_not_take(cuda, case, err):
    acc = torch.zeros((64,), device="cuda")
    part = torch.zeros((64,), device="cuda")
    op = "add"
    if case == "float16":
        acc, part = acc.half(), part.half()
    elif case == "strided":
        acc = torch.zeros((128,), device="cuda")[::2]
    elif case == "op":
        op = "prod"
    else:
        part = part[:63]
    before = segment_reduce.launches
    with pytest.raises(err):
        segment_reduce.segment_combine(acc, part, op)
    assert segment_reduce.launches == before


def _ring_on_card(n):
    from repro_torch.core.collectives import algorithms as alg
    from repro_torch.core.collectives import group as grp
    dev = grp.device_of("cuda")
    p, r = grp.size(), grp.rank()
    xs = [torch.randn((n,), generator=torch.Generator().manual_seed(i))
          .to(dev) for i in range(p)]
    segment_reduce.launches = 0
    got = alg.allreduce_ring(xs[r], None, p, segments=2)
    torch.cuda.synchronize()
    launches = segment_reduce.launches
    want = xs[0] + xs[1]
    shard = alg.reduce_scatter_ring(xs[r], None, p)
    want_shard = torch.nn.functional.pad(want, (0, (-n) % p)).reshape(p, -1)[r]
    return {"equal": bool(torch.equal(got, want)), "device": got.device.type,
            "launches": launches,
            "rs_equal": bool(torch.equal(shard, want_shard)),
            "rs_launches": segment_reduce.launches - launches}


def test_two_rank_host_staged_ring_all_reduce_on_the_card(cuda):
    """Two processes on one card (gloo, payloads staged through the host):
    the ring's and the ring reduce-scatter's reduce steps run in the
    kernel, in place into their buffers, and with two ranks each combine
    is the one fp32 add of the oracle, so the result is exact."""
    from repro_torch.core.collectives import group as grp
    res = grp.spawn(_ring_on_card, 2, (4099,))
    assert res == {"equal": True, "device": "cuda", "launches": 2,
                   "rs_equal": True, "rs_launches": 1}


def _exchange_on_card(seed):
    """One rank of a 2-rank ``("model",)`` mesh: the expert-parallel
    block's dispatch exchange there and back, and its gradient, on the
    card and on the host for each all-to-all; the card's bits against
    the host's."""
    from repro_torch.core.collectives import group as grp
    from repro_torch.models import moe
    mesh = grp.RankMesh((2,), ("model",), device=grp.device_of("cuda"))
    ax = mesh.axis("model")
    g = torch.Generator().manual_seed(seed + grp.rank())
    buf = torch.randn((8, 5, 16), generator=g).to(torch.bfloat16)
    ct = torch.randn((4, 10, 16), generator=g).to(torch.bfloat16)
    out = {}
    for algo in ("xla", "pairwise", "bruck"):
        got = []
        for dev in ("cuda", "cpu"):
            x = buf.to(dev).requires_grad_()
            y = moe._exchange(x, ax, 2, "fwd", algo)
            back = moe._exchange(y, ax, 2, "rev", algo)
            (gx,) = torch.autograd.grad(y, x, ct.to(dev))
            got.append((y.detach().cpu(), back.detach().cpu(), gx.cpu(),
                        y.device.type))
        (yc, bc, gc, dc), (yh, bh, gh, _) = got
        out[algo] = {"device": dc, "equal": torch.equal(yc, yh)
                     and torch.equal(bc, bh) and torch.equal(gc, gh),
                     "round_trip": torch.equal(bc, buf)}
    return out


def test_expert_exchange_and_its_gradient_on_the_card(cuda):
    """The dispatch all-to-all of expert parallelism (``moe._exchange``,
    each direction an autograd function whose backward is the other
    direction) over two ranks on one card: bit-equal to the same
    exchange of host tensors, back home after the round trip, for every
    all-to-all."""
    from repro_torch.core.collectives import group as grp
    res = grp.spawn(_exchange_on_card, 2, (5,))
    assert set(res) == {"xla", "pairwise", "bruck"}
    for algo, r in res.items():
        assert r == {"device": "cuda", "equal": True, "round_trip": True}, \
            algo


def _communicator_on_card(artifact, bucket_bytes, device="cuda"):
    import torch.distributed as dist
    from repro_torch import pytree
    from repro_torch.comms import Communicator
    from repro_torch.core.collectives import group as grp
    from repro_torch.launch import measure_collectives as mc
    dev = grp.device_of(device)
    mesh = grp.RankMesh((2, 2), ("pod", "data"), device=dev)
    comm = Communicator.create(mesh, artifact=artifact,
                               bucket_bytes=bucket_bytes)
    shapes = {"w": (33, 7), "b": (5,), "emb": (1000, 64), "ln": (64,)}

    def tree(r):
        g = torch.Generator().manual_seed(100 + r)
        return {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    mine = pytree.tree_map(lambda t: t.to(dev), tree(grp.rank()))
    segment_reduce.launches = 0
    out = comm.sync_gradients(mine)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = [None] * grp.size()
    dist.all_gather_object(launches, segment_reduce.launches)
    # the same sync over host tensors: the kernels' plain versions
    host = comm.sync_gradients(tree(grp.rank()))
    mean = {k: sum(tree(j)[k].double() for j in range(4)) / 4
            for k in shapes}
    err = max((out[k].double().cpu() - mean[k]).abs().max().item()
              for k in shapes)
    return {"launches": sum(launches),
            "plan": mc.plan_combines(comm.explain_gradients(mine), 4),
            "device": out["w"].device.type, "err": err,
            "plain_bits": all(torch.equal(out[k].cpu(), host[k])
                              for k in shapes)}


@pytest.mark.parametrize("bucket_bytes", [0, 4096])
def test_communicator_sync_on_the_card_launches_as_its_plan(cuda,
                                                            bucket_bytes):
    """A 2x2 ("pod", "data") mesh of four ranks on the card, the
    hierarchical artifact, per leaf and bucketed: every reduce step of
    every reduce-scatter and all-reduce phase is one kernel launch (the
    launches summed over the ranks equal what the plan implies), the
    result is the mean within the reference's 2e-4 for hierarchical
    sums, and it has the bits of the same sync over host tensors."""
    import os
    from repro_torch.core.collectives import group as grp
    artifact = os.path.join(os.path.dirname(__file__), "..", "examples",
                            "artifacts", "hierarchical_decision.json")
    res = grp.spawn(_communicator_on_card, 4, (artifact, bucket_bytes))
    assert res["device"] == "cuda" and res["plan"] > 0
    assert res["launches"] == res["plan"]
    assert res["err"] <= 2e-4 and res["plain_bits"]


def _overlapped_on_card(device="cuda"):
    """One backward of the reduced smollm-135m (bf16 compute, the flash
    kernels) under a synchronous release sink and under the sync thread,
    each then finished by ``sync_gradients_streamed``; and the
    overlapped training step's synced gradients against a step whose
    sync runs after the backward."""
    import os
    import torch.distributed as dist
    from repro_torch import pytree
    from repro_torch.comms import Communicator
    from repro_torch.configs import ARCHITECTURES, ParallelConfig, \
        ShapeConfig
    from repro_torch.configs.base import CollectiveConfig
    from repro_torch.core.collectives import group as grp
    from repro_torch.data import batch_to_tensors
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import layers as L
    from repro_torch.models.registry import make_train_batch
    dev = grp.device_of(device)
    mesh = grp.RankMesh((2, 2, 1), ("pod", "data", "model"), device=dev)
    artifact = os.path.join(os.path.dirname(__file__), "..", "examples",
                            "artifacts", "hierarchical_decision.json")
    comm = Communicator.create(mesh, artifact=artifact)
    cfg = ARCHITECTURES["smollm-135m"].reduced()
    shape = ShapeConfig(name="t", seq_len=256, global_batch=8, kind="train")
    par = ParallelConfig()
    steps = {o: build_train_step(cfg, shape, par, CollectiveConfig(
        decision=artifact, overlap_backward=o), mesh, communicator=comm,
        device=dev) for o in (False, True)}
    api = steps[True].api
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    batch = batch_to_tensors(make_train_batch(cfg, shape, seed=2), dev,
                             rows=steps[True].rows)
    out = {}
    for overlap in (False, True):
        leaves, treedef = pytree.flatten(params)
        leaves = [t.detach().requires_grad_() for t in leaves]
        sink = comm.release_sink(overlap=overlap, device=dev)
        with L.release_scope(sink):
            loss, _ = api.loss(treedef.unflatten(leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        out[overlap] = pytree.leaves(comm.sync_gradients_streamed(
            treedef.unflatten(list(grads)), sink, mean=True))
        out[f"events{overlap}"] = [i for _, i in sink.events]
    step_grads = {}
    for overlap, step in steps.items():
        p = pytree.tree_map(torch.clone, params)    # updated in place
        _, _, m = step.fn(p, step.opt.init(p), batch, keep_grads=True)
        step_grads[overlap] = (m["local_grads_fingerprint"],
                               pytree.leaves(m["grads"]))
    worst = max(((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30)).item()
                for a, b in zip(step_grads[True][1], step_grads[False][1]))
    res = {"bits": all(torch.equal(a, b) for a, b in
                       zip(out[True], out[False])),
           "device": out[True][0].device.type,
           "events": out["eventsTrue"] == out["eventsFalse"]
           == list(reversed(range(cfg.num_layers))),
           "fingerprints": step_grads[True][0] == step_grads[False][0],
           "step_rel": worst}
    parts = [None] * grp.size()
    dist.all_gather_object(parts, res)
    return parts


def test_overlapped_sync_equals_the_synchronous_release_on_the_card(cuda):
    """Four ranks on the card (the arena transport), 2x2, the hierarchical
    artifact: the gradients synced on each rank's sync thread (its own
    CUDA stream, while autograd runs the layers below) equal, bit for
    bit, those synced inside the backward by the synchronous sink, in
    every rank; releases come deepest layer first; the overlapped
    training step sees the plain step's gradients before the sync (bit
    checksums) and syncs them within 1e-6 (relative a leaf: per-layer
    buckets against per-leaf sums of the same 4 terms)."""
    from repro_torch.core.collectives import group as grp
    for res in grp.spawn(_overlapped_on_card, 4):
        assert res["device"] == "cuda" and res["bits"] and res["events"]
        assert res["fingerprints"] and res["step_rel"] <= 1e-6


# ---------------------------------------------------------------------------
# the paged decode attention kernel
# ---------------------------------------------------------------------------
def _paged_inputs(R, nb, bs, KV, H, Dh, q_dtype, kv_dtype, seed):
    """Pools with a null block 0 and shuffled int32 tables, on the card."""
    g = torch.Generator().manual_seed(seed)
    NB = 1 + R * nb
    kp = torch.randn((NB, bs, KV, Dh), generator=g).to(kv_dtype).cuda()
    vp = torch.randn((NB, bs, KV, Dh), generator=g).to(kv_dtype).cuda()
    tables = (1 + torch.randperm(R * nb, generator=g)).reshape(R, nb)
    q = torch.randn((R, 1, H, Dh), generator=g).to(q_dtype).cuda()
    return q, kp, vp, tables.to(torch.int32).cuda()


# the gather path's rounding: fp32 summation order only, so fp32 at 2e-5
# and bf16 within one bf16 ulp
PAGED_TOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}


def _off_by(got, want, tol):
    """Some element of ``got`` lies outside ``tol * (1 + |want|)``."""
    return bool(((got.float() - want.float()).abs()
                 > tol * (1 + want.float().abs())).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("R,nb,bs,KV,H,Dh", [
    (3, 3, 4, 2, 4, 64),          # the reference's setup at a built head dim
    (8, 36, 16, 3, 9, 64),        # smollm serving: GQA 3, view 576
    (4, 33, 16, 32, 32, 80),      # zamba2 serving, view 528
    (4, 33, 16, 16, 16, 128),     # olmoe serving, view 528
    (2, 2, 64, 1, 5, 128),        # block size 64, group 5
    (4, 1, 16, 2, 4, 80),         # one pool block: one split
    (33, 2, 16, 16, 16, 128),     # R*KV fills the card alone: one split
    (4, 33, 16, 2, 32, 128),      # glm4-9b / chatglm3-6b: group 16
    (4, 33, 16, 2, 16, 128),      # qwen2.5-3b: group 8
    (4, 33, 16, 8, 56, 128),      # arctic-480b: group 7
])
def test_paged_kernel_matches_plain(cuda, dtype, window, R, nb, bs, KV, H,
                                    Dh):
    q, kp, vp, tables = _paged_inputs(R, nb, bs, KV, H, Dh, dtype, dtype,
                                      seed=R + nb + Dh)
    T = nb * bs
    # partial, full, wrapped and several-wraps-deep views
    lengths = torch.tensor(([5, T, T + 5, 3 * T + 1] * R)[:R]).cuda()
    before = pa.launches
    got = pa.paged_attention(q, kp, vp, tables, lengths, window=window)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    want = ref.paged_attention_ref(q, kp, vp, tables, lengths, window=window)
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=PAGED_TOL[dtype], rtol=PAGED_TOL[dtype])


@pytest.mark.parametrize("R,nb,bs,KV,H,Dh", [
    (4, 33, 16, 8, 8, 80), (4, 8, 16, 4, 4, 128), (8, 36, 16, 3, 9, 128)])
def test_paged_kernel_bf16_rounds_where_the_dense_decode_rounds(cuda, R, nb,
                                                                bs, KV, H,
                                                                Dh):
    """q and K scaled by 8 peak the scores. On such a case fp32 q and P
    (the gather path on fp32 copies of the same bf16 values, the TPU
    kernel's rounding) land more than 4 ulps from the bf16 gather path,
    so the case tells the two apart; the kernel is within one ulp."""
    q, kp, vp, tables = _paged_inputs(R, nb, bs, KV, H, Dh, torch.float32,
                                      torch.float32, seed=7)
    q, kp, vp = (q * 8).bfloat16(), (kp * 8).bfloat16(), vp.bfloat16()
    T = nb * bs
    lengths = torch.tensor(([T - 3, T, T + 5] * R)[:R]).cuda()
    want = ref.paged_attention_ref(q, kp, vp, tables, lengths)
    fp32 = ref.paged_attention_ref(q.float(), kp.float(), vp.float(),
                                   tables, lengths)
    assert _off_by(fp32, want, 4 * PAGED_TOL[torch.bfloat16])
    got = pa.paged_attention(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=PAGED_TOL[torch.bfloat16],
                               rtol=PAGED_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("Dh", [64, 80, 128])
def test_paged_kernel_split_edges(cuda, dtype, window, Dh):
    """smollm's table (36 blocks of 16, 36 splits of 1 block) with an
    empty row (0), a row whose later splits hold no valid slot, rows
    whose wrapped ring crosses a split boundary inside the window, and a
    full view; each against the gather path, and the whole call against
    the kernel's split algebra at its own split size."""
    R, nb, bs, KV, H = 8, 36, 16, 3, 9
    T = nb * bs
    q, kp, vp, tables = _paged_inputs(R, nb, bs, KV, H, Dh, dtype, dtype,
                                      seed=Dh + window)
    lengths = torch.tensor([0, 20, T + 48, T + 50, T + 3, T, 1,
                            3 * T + 100]).cuda()
    bps, splits = pa.split_plan(R, KV, nb)
    assert (bps, splits) == (1, 36)
    got = pa.paged_attention(q, kp, vp, tables, lengths, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = ref.paged_attention_ref(q, kp, vp, tables, lengths, window=window)
    tol = PAGED_TOL[dtype]
    torch.testing.assert_close(got[1:].float(), want[1:].float(), atol=tol,
                               rtol=tol)
    split = pa.paged_attention_split_plain(q, kp, vp, tables, lengths,
                                           window=window,
                                           blocks_per_split=bps)
    torch.testing.assert_close(got.float(), split.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("R,nb,KV,H,Dh", [
    (8, 36, 3, 9, 64), (4, 33, 32, 32, 80), (4, 33, 16, 16, 128),
    (4, 33, 2, 32, 128)])           # glm4-9b's serving shape
def test_paged_kernel_is_deterministic_at_the_serving_shapes(cuda, R, nb, KV,
                                                             H, Dh):
    """The partials are summed in split order by whichever block arrives
    last: two calls on the same inputs give the same bits."""
    q, kp, vp, tables = _paged_inputs(R, nb, 16, KV, H, Dh, torch.bfloat16,
                                      torch.bfloat16, seed=11)
    lengths = torch.tensor(([nb * 16 - 7, nb * 16, 300, 1000] * R)[:R],
                           dtype=torch.int32).cuda()
    first = pa.paged_attention(q, kp, vp, tables, lengths)
    for _ in range(3):
        assert torch.equal(pa.paged_attention(q, kp, vp, tables, lengths),
                           first)


def test_paged_kernel_fp32_queries_over_bf16_pools(cuda):
    """fp32 compute over the engine's bf16 pools: the kernel, as the
    gather path, rounds the scaled q and the probabilities to bf16."""
    q, kp, vp, tables = _paged_inputs(4, 5, 16, 2, 4, 128, torch.float32,
                                      torch.bfloat16, seed=3)
    lengths = torch.tensor([1, 30, 80, 81]).cuda()
    got = pa.paged_attention(q, kp, vp, tables, lengths)
    want = ref.paged_attention_ref(q, kp, vp, tables, lengths)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=2 ** -7, rtol=2 ** -7)


def test_paged_kernel_empty_row_is_zero_and_strided_q(cuda):
    """A row with no valid slot gives 0 (the TPU kernel's l == 0 -> 1);
    q read through its strides."""
    q, kp, vp, tables = _paged_inputs(2, 2, 8, 1, 2, 64, torch.float32,
                                      torch.float32, seed=4)
    qs = torch.zeros((2, 1, 4, 64), device="cuda")[:, :, ::2]
    qs.copy_(q)
    got = pa.paged_attention(qs, kp, vp, tables, torch.tensor([0, 9]).cuda())
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = ref.paged_attention_ref(q, kp, vp, tables, torch.tensor([9, 9]))
    torch.testing.assert_close(got[1], want[1], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case,err", [
    ("float16", TypeError), ("head_dim_96", ValueError),
    ("block_128", ValueError), ("strided_pool", ValueError),
    ("two_tokens", ValueError), ("misaligned_pool", ValueError)])
def test_paged_kernel_refuses_what_it_does_not_take(cuda, case, err):
    q, kp, vp, tables = _paged_inputs(2, 2, 8, 1, 2, 64, torch.float32,
                                      torch.float32, seed=5)
    lengths = torch.tensor([3, 9]).cuda()
    if case == "float16":
        kp, vp = kp.half(), vp.half()
    elif case == "head_dim_96":
        q = torch.zeros((2, 1, 2, 96), device="cuda")
        kp = vp = torch.zeros((5, 8, 1, 96), device="cuda")
    elif case == "block_128":
        kp = vp = torch.zeros((5, 128, 1, 64), device="cuda")
    elif case == "strided_pool":
        kp = torch.zeros((5, 8, 2, 64), device="cuda")[:, :, :1]
    elif case == "misaligned_pool":      # contiguous, 4 bytes off 16
        kp = torch.zeros((5 * 8 * 64 + 1,), device="cuda")[1:].reshape(
            5, 8, 1, 64)
    else:
        q = q.expand(-1, 2, -1, -1)
    before = pa.launches
    with pytest.raises(err):
        pa.paged_attention(q, kp, vp, tables, lengths)
    assert pa.launches == before
