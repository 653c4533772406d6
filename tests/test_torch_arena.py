"""The arena transport's protocol (`group.Arena`) against ``gloo``, on the
CPU.

On the card a CUDA payload crosses through an arena that every rank maps
with CUDA IPC. The protocol around the map (two slots used in turn, the
counters that order the copies, growth in lockstep, one arena an axis so
that two threads may use two axes) does not depend on how the memory is
mapped, so here it runs over a test-only backing, `SharedFiles`: host
memory in files that every rank maps shared. Production CPU tensors
keep the ``gloo`` wire (checked too).

One spawned 4-rank ``gloo`` group on a 2 x 2 ``("data", "model")`` mesh
and a remapped one (``device_order`` [2, 3, 0, 1], so its data axis and
the default group taken as one axis carry a slot order). Every
collective of the module over the arena is held to the same collective
over ``gloo`` on the same inputs, fp32 and bf16: copies (``ppermute``
with a rank that is no destination and an ``(i, i)`` pair,
``all_gather``, ``all_to_all``, ``pmax``) bit-equal; sums (``psum``,
``reduce_scatter``) within reduction order, ``SUM_TOL`` of the largest
magnitude, and ``psum``'s the same bits on every rank of the axis; the
same with the largest slot cut to 4 KiB, so that every payload crosses
in rounds. The arena grows in lockstep; two threads use two axes at
once; ranks that issue different collectives raise, and so does a map
that fails.
"""
import os
import shutil
import sys
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.collectives import group as grp  # noqa: E402

#: |arena - gloo| / max|gloo| for a sum: the order of p - 1 additions
SUM_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SUMS = ("psum", "reduce_scatter")
AXES = ("data", "model", "mapped_data", "world")
ROUNDS = 24             # collectives a thread issues in the two-thread check


class SharedFiles:
    """A test-only arena backing: each arena a file that every rank maps
    shared (``torch.from_file``); the handle is its path."""

    name = "shared files"

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="arena_test_")
        self.n = 0

    def alloc(self, nbytes, device):
        path = os.path.join(self.dir, f"arena{self.n}")
        self.n += 1
        mem = torch.from_file(path, shared=True, size=nbytes,
                              dtype=torch.uint8)
        self.last = (path, nbytes)
        return mem

    def share(self, mem):
        return self.last

    def open(self, handle):
        path, nbytes = handle
        return torch.from_file(path, shared=True, size=nbytes,
                               dtype=torch.uint8)


class Refused(SharedFiles):
    """A backing whose map fails, as a refused ``cudaIpcOpenMemHandle``."""

    def open(self, handle):
        raise OSError("mapping refused")


def _perms(p):
    """One permutation with a rank that is no destination and an (i, i)
    pair, one with no crossing pair, and a cyclic shift."""
    mixed = [(0, 1), (3, 0), (2, 2)] if p == 4 else [(0, 1)]
    return {"mixed": mixed, "self": [(1, 1)],
            "shift": [(i, (i + 1) % p) for i in range(p)]}


def _arena_vs_gloo(arena, axis, x, op):
    """(arena's result, gloo's) of one collective on x."""
    if op.startswith("ppermute"):
        perm = _perms(axis.size)[op.split(":")[1]]
        return arena.ppermute(x, perm), grp.ppermute(x, perm, axis)
    return getattr(arena, op)(x), getattr(grp, op)(x, axis)


def _reading(got, want, op, dtype):
    """0 for bit-equal copies; a sum's max error over the largest value."""
    if op in SUMS:
        scale = float(want.float().abs().max()) or 1.0
        return float((got.float() - want.float()).abs().max()) / scale
    return 0.0 if torch.equal(got, want) else float("inf")


def _rank_work():
    import torch.distributed as dist
    me = grp.rank()
    mesh = grp.RankMesh((2, 2), ("data", "model"))
    mapped = grp.RankMesh((2, 2), ("data", "model"),
                          device_order=[2, 3, 0, 1])
    axes = {"data": mesh.axis("data"), "model": mesh.axis("model"),
            "mapped_data": mapped.axis("data"),
            "world": mapped.joint(("data", "model"))}
    backing = SharedFiles()
    arenas = {n: grp.Arena(a.group, a.order, backing, n)
              for n, a in axes.items()}
    out = {"orders": {n: a.order for n, a in axes.items()}}
    rng = np.random.default_rng(100 + me)

    def draw(shape, dtype):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(DTYPES[dtype])

    # every collective, fp32 and bf16, every axis
    ops = (*[f"ppermute:{k}" for k in ("mixed", "self", "shift")],
           "all_gather", "all_to_all", "pmax", "psum", "reduce_scatter")
    for name, axis in axes.items():
        for dtype in DTYPES:
            for op in ops:
                x = draw((axis.size * 3, 5), dtype)
                got, want = _arena_vs_gloo(arenas[name], axis, x, op)
                base = op.split(":")[0]
                out[(name, dtype, op)] = _reading(got, want, base, dtype)
                if op == "psum":        # the same bits on every rank
                    every = grp.all_gather(got, axis).chunk(axis.size)
                    out[(name, dtype, "psum_bits")] = all(
                        torch.equal(every[0], e) for e in every)
    # payloads past the largest slot cross in rounds of a slot each
    saved = grp.ARENA_MAX_BYTES
    grp.ARENA_MAX_BYTES = 4096
    try:
        rounds = grp.Arena(axes["world"].group, axes["world"].order,
                           backing, "world")
        for op in ops:
            x = draw((4 * 3, 1000), "float32")
            got, want = _arena_vs_gloo(rounds, axes["world"], x, op)
            out[("rounds", op)] = _reading(got, want, op.split(":")[0],
                                           "float32")
        out["rounds_seq"] = rounds.seq
        rounds.close()
    finally:
        grp.ARENA_MAX_BYTES = saved
    # growth: a payload past the slot, then a small one again
    arena, axis = arenas["data"], axes["data"]
    out["capacity"] = [arena.capacity]
    for n in (700_000, 4, 1_500_000):
        x = draw((2, n), "float32")
        got, want = _arena_vs_gloo(arena, axis, x, "psum")
        out[("grow", n)] = _reading(got, want, "psum", "float32")
        out["capacity"].append(arena.capacity)
    # two threads on two axes: psums over data on a thread while the main
    # thread all-gathers over model, each against gloo's earlier result
    xs = {n: [draw((6, 7), "float32") for _ in range(ROUNDS)]
          for n in ("data", "model")}
    want = {"data": [grp.psum(x, axes["data"]) for x in xs["data"]],
            "model": [grp.all_gather(x, axes["model"])
                      for x in xs["model"]]}
    got = {"data": [], "model": []}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=lambda: got["data"].extend(
            arenas["data"].psum(x) for x in xs["data"]))
        t.start()
        got["model"] = [arenas["model"].all_gather(x) for x in xs["model"]]
        t.join(timeout=120)
        out["thread_alive"] = t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    out["threads"] = (
        len(got["data"]) == ROUNDS
        and max(_reading(g, w, "psum", "float32")
                for g, w in zip(got["data"], want["data"])) <= SUM_TOL[
                    "float32"]
        and all(torch.equal(g, w) for g, w in zip(got["model"],
                                                  want["model"])))
    # ranks that issue different collectives raise instead of mixing them
    x = draw((4, 6), "float32")
    try:
        if grp.rank(axes["model"]) == 0:
            arenas["model"].psum(x)
        else:
            arenas["model"].all_gather(x)
        out["mismatch"] = "no error"
    except RuntimeError as e:
        out["mismatch"] = str(e)
    # a map that fails raises and names the error
    try:
        grp.Arena(axes["data"].group, axes["data"].order, Refused(),
                  "data").psum(x)
        out["refused"] = "no error"
    except RuntimeError as e:
        out["refused"] = str(e)
    # CPU tensors in production keep the gloo wire: no arena is made
    grp.psum(x, axes["model"])
    grp.all_to_all(x, axes["world"])
    out["production_arenas"] = len(grp._ARENAS)
    for a in arenas.values():
        a.close()
    dist.barrier()
    shutil.rmtree(backing.dir, ignore_errors=True)
    outs = [None] * grp.size()
    dist.all_gather_object(outs, out)
    return outs


@pytest.fixture(scope="module")
def run():
    return grp.spawn(_rank_work, 4, timeout_s=300)


def test_remapped_axes_carry_a_slot_order(run):
    for out in run:
        assert out["orders"]["mapped_data"] is not None
        assert out["orders"]["world"] is not None
        assert out["orders"]["data"] is None


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("op", ["ppermute:mixed", "ppermute:self",
                                "ppermute:shift", "all_gather",
                                "all_to_all", "pmax"])
def test_copies_are_bit_equal_to_gloo(run, op, axis, dtype):
    for out in run:
        assert out[(axis, dtype, op)] == 0.0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("op", SUMS)
def test_sums_equal_gloo_up_to_reduction_order(run, op, axis, dtype):
    for out in run:
        assert out[(axis, dtype, op)] <= SUM_TOL[dtype]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("axis", AXES)
def test_psum_is_the_same_bits_on_every_rank(run, axis, dtype):
    for out in run:
        assert out[(axis, dtype, "psum_bits")]


@pytest.mark.parametrize("op", ["ppermute:mixed", "ppermute:shift",
                                "all_gather", "all_to_all", "pmax", "psum",
                                "reduce_scatter"])
def test_payloads_past_the_largest_slot_cross_in_rounds(run, op):
    """With a 4 KiB largest slot, 12 x 1000 fp32 payloads cross in rounds
    of at most 4 KiB, each equal to gloo's as above."""
    tol = SUM_TOL["float32"] if op in SUMS else 0.0
    for out in run:
        assert out[("rounds", op)] <= tol
        # 12 KB a row in 4 KiB rounds: at least 3 rounds a collective
        assert out["rounds_seq"] >= 3 * 8


def test_the_arena_grows_in_lockstep(run):
    caps = run[0]["capacity"]
    assert caps[0] == grp.ARENA_MIN_BYTES
    assert caps[1] >= 2 * 700_000 * 4 and caps[2] == caps[1]
    assert caps[3] >= 2 * 1_500_000 * 4
    for out in run:
        assert out["capacity"] == caps
        for n in (700_000, 4, 1_500_000):
            assert out[("grow", n)] <= SUM_TOL["float32"]


def test_two_threads_on_two_axes(run):
    for out in run:
        assert not out["thread_alive"]
        assert out["threads"]


def test_ranks_issuing_different_collectives_raise(run):
    for out in run:
        assert "issued different collectives" in out["mismatch"], \
            out["mismatch"]


def test_a_failed_map_raises_and_names_the_error(run):
    for out in run:
        assert "shared files map of axis data" in out["refused"], \
            out["refused"]
        assert "OSError: mapping refused" in out["refused"]


def test_cpu_tensors_keep_the_gloo_wire(run):
    for out in run:
        assert out["production_arenas"] == 0
