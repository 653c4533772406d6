"""FSDP in training for the SSM, hybrid and enc-dec families against the
JAX package, as ``tests/test_torch_fsdp.py`` holds the dense stack's
(the reference's untuned FSDP step in one subprocess with 4 simulated
devices, the port's in one 4-rank ``gloo`` group, fp32 compute).

- mamba2-130m on ``("data",)`` 4 (``in_proj``, ``out_proj`` and the
  embeddings sharded; the SSM's small parameters replicated), zamba2-2.7b
  on ``("pod", "data")`` 2x2 (the shared block gathered once a forward
  and its gradient reduce-scattered once, summed over its uses) and
  whisper-large-v3 on 4 (encoder, decoder and cross-attention; the
  learned positions replicated): one step against the reference's and
  against the port's step without FSDP, with the tolerances and checks
  of ``tests/test_torch_fsdp.py``.
- ``gather_in_compute_dtype`` (whisper on 2x2: the shards cast to bf16
  before the gather, their gradients reduce-scattered in bf16) against
  the reference's same knob: the loss and each leaf's synced gradient
  within 2e-2.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_fsdp import (  # noqa: E402
    BF16_TOL,
    check_against_plain,
    check_against_reference,
    run_cases,
)

CASES = (("mamba2", "mamba2-130m", "4", False, False, False),
         ("zamba2", "zamba2-2.7b", "2x2", False, False, False),
         ("whisper", "whisper-large-v3", "4", False, False, False),
         ("whisper_bf16", "whisper-large-v3", "2x2", True, False, False))
FP32_CASES = CASES[:3]
# each family's sharded leaves at its reduced widths (d 256, dp 4): the
# embeddings' two; mamba2 and zamba2 in_proj and out_proj a layer (and
# zamba2's shared attention's four and MLP's three); whisper's encoder
# attention four and MLP two, its decoder's two attentions eight and MLP
# two, a layer
SHARDED = {"mamba2": 2 + 2 * 2, "zamba2": 2 + 2 * 2 + 7,
           "whisper": 2 + 2 * 6 + 2 * 10}
# the rest of the tree's gather and one a layer
GATHERS = {"mamba2": 1 + 2, "zamba2": 1 + 2, "whisper": 1 + 2 + 2}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("fsdp_families"), CASES)


@pytest.mark.parametrize("case", FP32_CASES, ids=[c[0] for c in FP32_CASES])
def test_fsdp_step_matches_the_reference(run, case):
    check_against_reference(run, case)


@pytest.mark.parametrize("case", FP32_CASES, ids=[c[0] for c in FP32_CASES])
def test_fsdp_step_matches_the_step_without_fsdp(run, case):
    check_against_plain(run, case)


@pytest.mark.parametrize("case", FP32_CASES, ids=[c[0] for c in FP32_CASES])
def test_each_family_shards_its_main_leaves(run, case):
    tag = case[0]
    for port in run.port:
        assert int(port[f"{tag}|sharded"]) == SHARDED[tag]
        gathers, scatters, _ = port[f"{tag}|fsdp|collectives"].tolist()
        assert gathers == scatters == GATHERS[tag]


def test_gather_in_compute_dtype_matches_the_reference(run):
    """The loss within 2e-2 of the reference step's, and step 0's synced
    gradients within 2e-2 per leaf (relative 2-norm) of the reference's
    gradient of its cast loss: each rank rounds its cotangents to bf16
    and the reduce-scatter sums them in bf16, where XLA rounds its own
    partial sums. The params' change is not held here: Adam's first
    step is the gradient's sign, so those bf16 steps flip the update of
    a few entries in 10^4 that are near 0 (~3.5e-2 a leaf, read)."""
    import numpy as np
    tag = "whisper_bf16"
    want = float(run.ref[f"{tag}|step|loss"])
    for port in run.port:
        assert abs(float(port[f"{tag}|fsdp|loss"]) - want) <= \
            BF16_TOL * abs(want)
        assert bool(port[f"{tag}|fsdp|replicas"])
        prefix = f"{tag}|fsdp|grad|"
        keys = [k for k in port if k.startswith(prefix)]
        assert keys
        for k in keys:
            got = port[k].astype(np.float64)
            ref = run.ref[f"{tag}|grad|{k[len(prefix):]}"].astype(
                np.float64)
            assert np.linalg.norm(got - ref) <= \
                BF16_TOL * np.linalg.norm(ref), k
