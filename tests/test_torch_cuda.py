"""The port's CUDA kernels on the card, against their plain versions.

These imports hold no JAX, so the file also runs on a machine with a GPU
and no JAX: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``. Elsewhere every test skips: a CUDA kernel
has no CPU mode (its arithmetic is held against the reference on the CPU
through ``flash_attention_plain``, ``ssd_chunked_plain``,
``segment_combine_plain`` and ``ref.paged_attention_ref``, in
``tests/test_torch_kernels.py``, ``tests/test_torch_ssm.py``,
``tests/test_torch_collectives.py`` and
``tests/test_torch_paged_attention.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import segment_reduce  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402

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
])
def test_ssd_kernel_matches_plain(cuda, dtype, B, S, H, P, N, chunk):
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, dtype, seed=S + N)
    assert x.stride(-1) == 1 and not x.is_contiguous()
    before = ssd_scan.launches
    got = ssd_scan.ssd_chunk(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want = ssd_scan.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=SSD_TOL[dtype],
                                   rtol=SSD_TOL[dtype])


@pytest.mark.parametrize("case,err", [
    ("float16", TypeError), ("head_dim_48", ValueError),
    ("chunk_129", ValueError), ("ragged_chunk", ValueError)])
def test_ssd_kernel_refuses_what_it_does_not_take(cuda, case, err):
    x, dt, A, Bm, Cm = _ssd_inputs(1, 258, 2, 64, 16, torch.float32, seed=1)
    chunk = 129 if case == "chunk_129" else 43
    if case == "float16":
        x, Bm, Cm = x.half(), Bm.half(), Cm.half()
    elif case == "head_dim_48":
        x = torch.zeros((1, 258, 2, 48), device="cuda")
    elif case == "ragged_chunk":
        chunk = 100
    before = ssd_scan.launches
    with pytest.raises(err):
        ssd_scan.ssd_chunk(x, dt, A, Bm, Cm, chunk=chunk)
    assert ssd_scan.launches == before


# ---------------------------------------------------------------------------
# the segment-combine kernel and a host-staged collective on the card
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


def test_segment_combine_propagates_nan(cuda):
    acc = torch.tensor([float("nan"), 1.0, 2.0, float("nan")], device="cuda")
    part = torch.tensor([1.0, float("nan"), 3.0, float("nan")], device="cuda")
    for op in ("add", "max", "min"):
        got = segment_reduce.segment_combine(acc, part, op)
        want = segment_reduce.segment_combine_plain(acc, part, op)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got[2:3], want[2:3])


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
    want = xs[0] + xs[1]
    return {"equal": bool(torch.equal(got, want)), "device": got.device.type,
            "launches": segment_reduce.launches}


def test_two_rank_host_staged_ring_all_reduce_on_the_card(cuda):
    """Two processes on one card (gloo, payloads staged through the host):
    the ring's reduce steps run in the kernel, and with two ranks each
    combine is the one fp32 add of the oracle, so the result is exact."""
    from repro_torch.core.collectives import group as grp
    res = grp.spawn(_ring_on_card, 2, (4099,))
    assert res == {"equal": True, "device": "cuda", "launches": 2}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("R,nb,bs,KV,H,Dh", [
    (3, 3, 4, 2, 4, 64),          # the reference's setup at a built head dim
    (8, 36, 16, 3, 9, 64),        # smollm serving: GQA 3, view 576
    (4, 33, 16, 32, 32, 80),      # zamba2 serving, view 528
    (4, 33, 16, 16, 16, 128),     # olmoe serving, view 528
    (2, 2, 64, 1, 5, 128),        # block size 64, group 5
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
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_paged_kernel_fp32_queries_over_bf16_pools(cuda):
    """fp32 compute over the engine's bf16 pools: the kernel keeps q and
    the probabilities in fp32, the gather path rounds both to bf16."""
    q, kp, vp, tables = _paged_inputs(4, 5, 16, 2, 4, 128, torch.float32,
                                      torch.bfloat16, seed=3)
    lengths = torch.tensor([1, 30, 80, 81]).cuda()
    got = pa.paged_attention(q, kp, vp, tables, lengths)
    want = ref.paged_attention_ref(q, kp, vp, tables, lengths)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


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
    ("two_tokens", ValueError)])
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
    else:
        q = q.expand(-1, 2, -1, -1)
    before = pa.launches
    with pytest.raises(err):
        pa.paged_attention(q, kp, vp, tables, lengths)
    assert pa.launches == before
