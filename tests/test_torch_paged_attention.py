"""The port's paged decode attention against the JAX package.

The same numpy pools, tables, queries and lengths go through the JAX
package's ``paged_attention`` (its gather path ``impl="xla"`` and its
Pallas kernel body in interpret mode, as ``tests/test_paged_attention.py``
runs it on the CPU) and the port's ``ref.paged_attention_ref``, over the
reference's setups (partial, full and wrapped views, windows 0 and 6)
plus GQA shapes at the served head dims 64, 80 and 128. The CUDA
kernel's split algebra, ``paged_attention_split_plain``, is held to both
at every split size. The port's layer is held to its own dense decode
bit for bit. The CUDA kernel runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_attention as jpa  # noqa: E402
from repro_torch.configs import ARCHITECTURES  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

# (R, blocks per request, block size, KV, H, Dh)
SETUPS = [
    (3, 3, 4, 2, 4, 8),           # tests/test_paged_attention.py
    (4, 3, 16, 3, 9, 64),         # smollm's heads (GQA 3)
    (2, 4, 8, 4, 4, 80),          # zamba2's head dim
    (3, 2, 16, 2, 2, 128),        # olmoe's head dim
]


def _setup(R, nb, bs, KV, H, Dh, seed=0):
    """Pools with a null block 0 and shuffled tables (block order must
    matter), as numpy fp32."""
    rng = np.random.default_rng(seed)
    num_blocks = 1 + R * nb
    k_pool = rng.normal(size=(num_blocks, bs, KV, Dh)).astype(np.float32)
    v_pool = rng.normal(size=(num_blocks, bs, KV, Dh)).astype(np.float32)
    ids = rng.permutation(np.arange(1, num_blocks))
    tables = ids.reshape(R, nb).astype(np.int32)
    q = rng.normal(size=(R, 1, H, Dh)).astype(np.float32)
    return q, k_pool, v_pool, tables


def _lengths(R, T, kind):
    """partial, full and wrapped views; ``deep``: several wraps."""
    base = {"mixed": [5, T, T + 5], "deep": [2 * T + 3, 3 * T, T + 1]}[kind]
    return np.asarray((base * R)[:R], np.int32)


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(np.array(a)) for a in arrs])


@pytest.mark.parametrize("kind", ["mixed", "deep"])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("setup", SETUPS)
def test_ref_matches_jax_xla_and_pallas_interpret(setup, window, kind):
    R, nb, bs, KV, H, Dh = setup
    q, kp, vp, tables = _setup(*setup, seed=Dh + window)
    lengths = _lengths(R, nb * bs, kind)
    j, t = _both((q, kp, vp, tables, lengths))
    got = ref.paged_attention_ref(*t, window=window).numpy()
    xla = jpa.paged_attention(*j, window=window, impl="xla")
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-6, rtol=1e-6)
    pallas = jpa.paged_attention(*j, window=window, impl="interpret")
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-6, rtol=2e-6)


def test_ring_slot_positions_match_jax_per_length_and_per_row():
    T = 12
    lens = (0, 1, 5, T, T + 5, 3 * T + 1)
    for length in lens:
        want = np.asarray(jpa.ring_slot_positions(jnp.int32(length), T))
        np.testing.assert_array_equal(
            ref.ring_slot_positions(torch.tensor(length), T).numpy(), want)
    rows = ref.ring_slot_positions(torch.tensor(lens), T)
    assert torch.equal(rows, torch.stack(
        [ref.ring_slot_positions(torch.tensor(n), T) for n in lens]))
    assert L.ring_slot_positions is ref.ring_slot_positions   # one ring rule


def test_table_order_matters():
    """Swapping blocks in a table permutes the view: over a PARTIAL view
    the output must change (guards against a read that ignores order)."""
    R, nb, bs, KV, H, Dh = SETUPS[0]
    q, kp, vp, tables = _setup(*SETUPS[0], seed=3)
    _, (q, kp, vp, tables) = _both((q, kp, vp, tables))
    lengths = torch.full((R,), 6)                 # second block half full
    base = ops.paged_attention(q, kp, vp, tables, lengths)
    perm = ops.paged_attention(q, kp, vp, tables.flip(1), lengths)
    assert not torch.allclose(base, perm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_auto_on_cpu_is_the_gather_path_exactly(dtype):
    R, nb, bs, KV, H, Dh = SETUPS[1]
    _, (q, kp, vp, tables) = _both(_setup(*SETUPS[1], seed=4))
    kp, vp = kp.to(dtype), vp.to(dtype)
    lengths = torch.from_numpy(_lengths(R, nb * bs, "mixed"))
    before = pa.launches
    auto = ops.paged_attention(q, kp, vp, tables, lengths, window=6)
    for impl in ("xla", "ref"):
        other = ops.paged_attention(q, kp, vp, tables, lengths, window=6,
                                    impl=impl)
        assert torch.equal(auto, other)
    assert torch.equal(auto, pa.paged_attention(q, kp, vp, tables.long(),
                                                lengths, window=6))
    assert pa.launches == before == 0            # CPU tensors never launch


def test_wrapper_refuses_bad_shapes_impls_and_devices():
    _, (q, kp, vp, tables) = _both(_setup(*SETUPS[0], seed=5))
    with pytest.raises(ValueError, match="one token per request"):
        pa.paged_attention(q.expand(-1, 2, -1, -1), kp, vp, tables,
                           torch.tensor([1, 1, 1]))
    with pytest.raises(ValueError, match="lengths"):
        pa.paged_attention(q, kp, vp, tables, torch.tensor([1, 1]))
    with pytest.raises(ValueError, match="unknown paged attention impl"):
        ops.paged_attention(q, kp, vp, tables, torch.tensor([1, 1, 1]),
                            impl="pallas")
    meta = torch.empty(q.shape, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pa.paged_attention(meta, kp, vp, tables, torch.tensor([1, 1, 1]))


def _block_and_caches(dtype, seed):
    """Small attention params and the same view twice: as a dense (B, T)
    cache and as pools + shuffled tables (with a null block 0)."""
    cfg = ARCHITECTURES["smollm-135m"].reduced()
    g = torch.Generator().manual_seed(seed)
    with torch.inference_mode():
        p = L.attention_params(g, cfg)
    KV, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    B, nb, bs = 3, 3, 4
    T = nb * bs
    rng = np.random.default_rng(seed)
    dense_k = torch.from_numpy(rng.normal(size=(B, T, KV, Dh))).to(dtype)
    dense_v = torch.from_numpy(rng.normal(size=(B, T, KV, Dh))).to(dtype)
    tables = torch.from_numpy(rng.permutation(np.arange(1, 1 + B * nb))
                              .reshape(B, nb).astype(np.int32))
    kp = torch.zeros((1 + B * nb, bs, KV, Dh), dtype=dtype)
    vp = torch.zeros_like(kp)
    kp[tables.long()] = dense_k.reshape(B, nb, bs, KV, Dh)
    vp[tables.long()] = dense_v.reshape(B, nb, bs, KV, Dh)
    x = torch.from_numpy(rng.normal(size=(B, 1, cfg.d_model))).float()
    return cfg, p, x, (dense_k, dense_v), (kp, vp, tables)


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_block_paged_decode_bit_equal_to_dense(dtype, window):
    """The paged form (token written in place into the pool, then the
    pool read through the tables) gives the dense decode's output bit for
    bit, and the pools then hold exactly the dense cache's view,
    including a wrapped ring slot."""
    cfg, p, x, (ck, cv), (kp, vp, tables) = _block_and_caches(dtype, 1)
    T = ck.shape[1]
    length = torch.tensor([5, T - 1, T + 7])      # the last one wraps
    positions = length[:, None]
    with torch.inference_mode():
        dense, dkv = L.attention_block(
            x, p, cfg, positions, window=window,
            kv_cache={"k": ck, "v": cv, "length": length},
            compute_dtype=torch.float32)
        paged, pkv = L.attention_block(
            x, p, cfg, positions, window=window,
            kv_cache={"k_pool": kp, "v_pool": vp, "block_tables": tables,
                      "length": length},
            compute_dtype=torch.float32, attn_impl="auto")
    assert torch.equal(dense, paged)
    assert torch.equal(dkv["length"], pkv["length"])
    assert pkv["k_pool"] is kp and pkv["v_pool"] is vp   # written in place
    assert torch.equal(ref.gather_kv_view(kp, tables), ck)
    assert torch.equal(ref.gather_kv_view(vp, tables), cv)
    assert not kp[0].any()                       # the null block untouched


def test_write_paged_token_lands_in_its_ring_slot():
    kp = torch.zeros((5, 2, 1, 1))
    tables = torch.tensor([[3, 1], [2, 4]], dtype=torch.int32)
    new = L.write_paged_token(
        {"k_pool": kp, "v_pool": kp.clone(), "block_tables": tables,
         "length": torch.tensor([3, 4])},
        torch.tensor([[[7.0]], [[9.0]]]), torch.zeros((2, 1, 1)))
    # row 0: slot 3 -> block tables[0, 1] = 1, offset 1; row 1 wraps to
    # slot 0 -> block 2, offset 0
    assert kp[1, 1, 0, 0] == 7.0 and kp[2, 0, 0, 0] == 9.0
    assert int(kp.count_nonzero()) == 2
    assert torch.equal(new["length"], torch.tensor([4, 5]))


# ---------------------------------------------------------------------------
# the CUDA kernel's split algebra in plain PyTorch
# ---------------------------------------------------------------------------
BF16_ULP = 2 ** -7            # one bf16 ulp at 1: the bf16 tolerance
# pool blocks per split; "whole": one split over the whole table
BLOCKS_PER_SPLIT = [1, 2, 3, "whole"]


def _bps(bps, nb):
    return nb if bps == "whole" else bps


@functools.lru_cache(maxsize=None)
def _jax_paged(setup, window, kind):
    """The JAX package's gather path and its Pallas kernel in interpret
    mode on one setup, once for every split size."""
    R, nb, bs, KV, H, Dh = setup
    q, kp, vp, tables = _setup(*setup, seed=Dh + window)
    lengths = _lengths(R, nb * bs, kind)
    j = [jnp.asarray(a) for a in (q, kp, vp, tables, lengths)]
    return (np.asarray(jpa.paged_attention(*j, window=window, impl="xla")),
            np.asarray(jpa.paged_attention(*j, window=window,
                                           impl="interpret")))


@pytest.mark.parametrize("bps", BLOCKS_PER_SPLIT)
@pytest.mark.parametrize("kind", ["mixed", "deep"])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("setup", SETUPS)
def test_split_plain_matches_ref_and_jax(setup, window, kind, bps):
    """fp32: per-split max and sum, their merge, and the partials summed
    in split order give the gather path's function; the short, windowed
    and wrapped views leave splits with no valid slot, and split
    boundaries inside a wrapped window."""
    R, nb, bs, KV, H, Dh = setup
    q, kp, vp, tables = _setup(*setup, seed=Dh + window)
    lengths = _lengths(R, nb * bs, kind)
    _, t = _both((q, kp, vp, tables, lengths))
    got = pa.paged_attention_split_plain(
        *t, window=window, blocks_per_split=_bps(bps, nb)).numpy()
    want = ref.paged_attention_ref(*t, window=window).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    xla, pallas = _jax_paged(setup, window, kind)
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)


def _bf16_setup(setup, seed, scale=1.0):
    """bf16 q and pools; ``scale`` multiplies q and K, which sharpens the
    scores."""
    q, kp, vp, tables = _setup(*setup, seed=seed)
    _, (q, kp, vp, tables) = _both((q, kp, vp, tables))
    return ((q * scale).bfloat16(), (kp * scale).bfloat16(), vp.bfloat16(),
            tables)


@pytest.mark.parametrize("bps", BLOCKS_PER_SPLIT)
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("setup", SETUPS[1:])
def test_split_plain_bf16_within_one_ulp_of_the_gather_path(setup, window,
                                                            bps):
    """bf16 q and pools: q rounded to the pool dtype, P normalised over
    the whole row and then rounded, as the gather path does; only the
    order of the fp32 sums differs."""
    R, nb, bs, KV, H, Dh = setup
    q, kp, vp, tables = _bf16_setup(setup, seed=Dh + window)
    T = nb * bs
    lengths = torch.tensor(([5, T, T + 5, 2 * T + 3] * R)[:R])
    got = pa.paged_attention_split_plain(q, kp, vp, tables, lengths,
                                         window=window,
                                         blocks_per_split=_bps(bps, nb))
    want = ref.paged_attention_ref(q, kp, vp, tables, lengths,
                                   window=window)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_ULP,
                               rtol=BF16_ULP)


def _off_by(got, want, tol):
    """Some element of ``got`` lies outside ``tol * (1 + |want|)``."""
    return bool(((got.float() - want.float()).abs()
                 > tol * (1 + want.float().abs())).any())


# (R, blocks per request, block size, KV, H, Dh): many rows, head dims
# whose scale D**-0.5 is inexact in bf16
SHARP_SETUPS = [(4, 33, 16, 8, 8, 80), (4, 8, 16, 4, 4, 128)]


@pytest.mark.parametrize("setup", SHARP_SETUPS)
def test_split_plain_bf16_sharp_scores_round_as_the_gather_path(setup):
    """q and K scaled by 8 give peaked scores, on which fp32 q and P (the
    gather path on fp32 copies of the same bf16 values) land more than 4
    ulps from the bf16 gather path: the case tells the two roundings
    apart, and the split algebra takes the gather path's."""
    R, nb, bs, KV, H, Dh = setup
    q, kp, vp, tables = _bf16_setup(setup, seed=7, scale=8.0)
    T = nb * bs
    lengths = torch.tensor(([T - 3, T, T + 5] * R)[:R])
    want = ref.paged_attention_ref(q, kp, vp, tables, lengths)
    fp32 = ref.paged_attention_ref(q.float(), kp.float(), vp.float(),
                                   tables, lengths)
    assert _off_by(fp32, want, 4 * BF16_ULP)
    for bps in (1, nb):
        got = pa.paged_attention_split_plain(q, kp, vp, tables, lengths,
                                             blocks_per_split=bps)
        assert not _off_by(got, want, BF16_ULP)


@pytest.mark.parametrize("window", [0, 6])
def test_split_plain_empty_row_is_zero(window):
    """A row with no valid slot gives 0 (every split's sum is 0); the
    other rows are the gather path's."""
    setup = SETUPS[1]
    R, nb, bs, KV, H, Dh = setup
    q, kp, vp, tables = _setup(*setup, seed=9)
    _, (q, kp, vp, tables) = _both((q, kp, vp, tables))
    lengths = torch.tensor([0, 3, nb * bs + 17, 1])
    for bps in (1, 2, nb):
        got = pa.paged_attention_split_plain(q, kp, vp, tables, lengths,
                                             window=window,
                                             blocks_per_split=bps)
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        want = ref.paged_attention_ref(q, kp, vp, tables, lengths,
                                       window=window)
        torch.testing.assert_close(got[1:], want[1:], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("R,KV,nb", [(8, 3, 36), (4, 32, 33), (4, 16, 33)])
def test_split_plan_fills_the_card_at_the_serving_shapes(R, KV, nb):
    """smollm, zamba2 and olmoe's continuous decode: at least
    ``BLOCKS_PER_SM`` (four) thread blocks per SM of an H100, and the
    splits cover the table once."""
    bps, splits = pa.split_plan(R, KV, nb)
    assert R * KV * splits >= pa.BLOCKS_PER_SM * 132 >= 4 * 132
    assert (splits - 1) * bps < nb <= splits * bps
    assert pa.split_plan(R, KV, nb, sms=1)[1] == 1     # R*KV fills it alone
