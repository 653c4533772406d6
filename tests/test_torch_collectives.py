"""The port's collectives slice against the JAX package, on the CPU.

* ``segment_combine``'s plain version against the Pallas kernel in
  interpret mode over the reference's sweep (equal, at ``atol=1e-6``).
* Every algorithm of ``ALGORITHMS``, every synthesized program family and
  ``ppermute`` itself: the same numpy inputs through the reference (one
  subprocess with ``--xla_force_host_platform_device_count=5``, one
  ``shard_map`` over the first p devices for each p, outputs to an
  ``.npz``) and through the port (one spawned ``gloo`` group of p
  processes per p, running the whole sweep). Every non-``"xla"``
  algorithm gives the reference's bits at p in {2, 4}, and Bruck, ring
  and recursive-doubling ``all_gather`` (with the any-p program families)
  at p in {3, 5}; the ``"xla"`` sums, the backends' own collectives,
  agree to ``rtol=1e-6`` in fp32 (in bf16: within the p-1 roundings of
  the partial sums) and with the oracle sum.
* The tuning core: simulator-tuned tables are byte-identical, session
  caches and the committed artifact load across packages, and the
  device-measured launcher's table loads in the reference.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.collectives import synth as jsynth  # noqa: E402
from repro.core import tuning as jtuning  # noqa: E402
from repro.kernels.segment_reduce import segment_combine_pallas  # noqa: E402
from repro_torch.core import tuning as ttuning  # noqa: E402
from repro_torch.core.collectives import algorithms as talg  # noqa: E402
from repro_torch.core.collectives import group as grp  # noqa: E402
from repro_torch.core.collectives import synth as tsynth  # noqa: E402
from repro_torch.kernels import ops, segment_reduce  # noqa: E402

HERE = os.path.dirname(__file__)
ROOT = os.path.join(HERE, "..")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("n", [7, 128, 1000, 65536])
def test_plain_segment_combine_matches_pallas(n, op, dtype):
    rng = np.random.default_rng(n)
    a, b = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    want = segment_combine_pallas(jnp.asarray(a, JDT[dtype]),
                                  jnp.asarray(b, JDT[dtype]), op,
                                  interpret=True)
    ta, tb = (torch.from_numpy(v).to(TDT[dtype]) for v in (a, b))
    for got in (segment_reduce.segment_combine_plain(ta, tb, op),
                ops.segment_combine(ta, tb, op),
                ops.segment_combine(ta, tb, op, impl="ref")):
        assert got.dtype == TDT[dtype]
        got, w = got.float().numpy(), np.asarray(want, np.float32)
        np.testing.assert_allclose(got, w, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_plain_segment_combine_in_place_matches_pallas(op, dtype):
    """``out=acc`` writes the out-of-place bits into acc, through the
    wrapper and through ``ops`` (both impls), on a row view of a buffer
    as the ring passes it."""
    rng = np.random.default_rng(11)
    a, b = (rng.normal(size=(3, 1000)).astype(np.float32) for _ in range(2))
    want = segment_combine_pallas(jnp.asarray(a[1], JDT[dtype]),
                                  jnp.asarray(b[1], JDT[dtype]), op,
                                  interpret=True)
    want = np.asarray(want, np.float32)
    for call in (segment_reduce.segment_combine, ops.segment_combine,
                 lambda x, y, o, out: ops.segment_combine(x, y, o, out=out,
                                                          impl="ref")):
        buf = torch.from_numpy(a.copy()).to(TDT[dtype])
        keep = buf.clone()
        acc = buf[1]
        got = call(acc, torch.from_numpy(b[1]).to(TDT[dtype]), op, out=acc)
        assert got.data_ptr() == acc.data_ptr()
        np.testing.assert_array_equal(buf[1].float().numpy(), want)
        assert torch.equal(buf[0], keep[0]) and torch.equal(buf[2], keep[2])


@pytest.mark.parametrize("case", ["shape", "dtype", "strided",
                                  "overlaps_part", "shifted_acc"])
def test_segment_combine_refuses_a_bad_out(case):
    buf = torch.zeros(256)
    acc, part = buf[:64], torch.zeros(64)
    out = {"shape": torch.zeros(63),
           "dtype": torch.zeros(64, dtype=torch.bfloat16),
           "strided": torch.zeros(128)[::2],
           "overlaps_part": part[:],
           "shifted_acc": buf[8:72]}[case]
    with pytest.raises(ValueError, match="out must"):
        segment_reduce.segment_combine(acc, part, "add", out=out)
    assert (buf == 0).all()


def test_step_program_rows_combine_in_place_only_as_a_view():
    """The step interpreter combines in place where the received rows are
    one ascending run (a slice is a view), and out of place for any other
    list (a list index copies)."""
    from repro_torch.core.collectives import program
    assert program._ascending_run([2]) == slice(2, 3)
    assert program._ascending_run([1, 2, 3]) == slice(1, 4)
    for rows in ([3, 0], [0, 2], [2, 1], []):
        assert program._ascending_run(rows) is None


def test_cpu_tensors_never_count_a_launch():
    a = torch.ones(64)
    before = segment_reduce.launches
    segment_reduce.segment_combine(a, a, "add")
    ops.segment_combine(a, a, "max")
    assert segment_reduce.launches == before == 0


def test_other_devices_raise_instead_of_falling_back():
    # meta tensors take the accounting's meta path: the kernel's output,
    # no launch, no plain version (repro_torch.count)
    a = torch.empty((64,), device="meta")
    before = segment_reduce.launches
    out = segment_reduce.segment_combine(a, a)
    assert out.device.type == "meta" and out.shape == a.shape
    assert segment_reduce.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        segment_reduce.segment_combine(torch.ones(64), a)
    with pytest.raises(ValueError, match="unknown op"):
        segment_reduce.segment_combine(torch.ones(4), torch.ones(4), "prod")
    with pytest.raises(ValueError, match="unknown segment_combine impl"):
        ops.segment_combine(torch.ones(4), torch.ones(4), impl="pallas")


# ---------------------------------------------------------------------------
# every algorithm, port vs reference, on the same numpy inputs
# ---------------------------------------------------------------------------
N = 1003                    # pads at every p and segment count
SEGMENTED = {("all_reduce", "ring"): (1, 2, 3), ("broadcast", "chain"): (1, 4),
             ("broadcast", "pipelined_binary"): (1, 4)}
NON_POW2 = ("ring", "recursive_doubling", "bruck")


def _perms(p):
    """ppermute cases: a chain (rank 0 only sends, the last destination
    only receives, the others get zeros), local copies, and a mix."""
    return {"chain": [(0, 1), (1, 2 % p)] if p > 2 else [(0, 1)],
            "self": [(i, i) for i in range(p)],
            "mixed": [(0, 0), (1, p - 1)] if p > 2 else [(1, 0)]}


def _cases(p):
    """key -> (op, algorithm or perm name, segments, dtype, input name)."""
    out = {}
    dtypes = ("float32", "bfloat16")
    if p & (p - 1) == 0:
        for op, algos in talg.ALGORITHMS.items():
            for name in algos:
                if op == "barrier":
                    out[f"barrier|{name}"] = (op, name, 1, "float32", "x")
                    continue
                for segs in SEGMENTED.get((op, name), (1,)):
                    for dt in dtypes:
                        out[f"{op}|{name}|s{segs}|{dt}"] = (
                            op, name, segs, dt,
                            "a2a" if op == "all_to_all" else "x")
    else:
        for name in NON_POW2:
            for dt in dtypes:
                out[f"all_gather|{name}|s1|{dt}"] = ("all_gather", name, 1,
                                                     dt, "x")
    for op in tsynth.PROGRAM_OPS:
        for name in sorted(tsynth.families(op, p)):
            for dt in dtypes:
                out[f"{op}|synth:{name}|s1|{dt}"] = (op, "synth:" + name, 1,
                                                     dt, "x")
    for name in _perms(p):
        out[f"ppermute|{name}"] = ("ppermute", name, 1, "float32", "x")
    return out


def _inputs(p):
    rng = np.random.default_rng(100 + p)
    return {"x": rng.normal(size=(p, N)).astype(np.float32),
            "a2a": rng.normal(size=(p, p * 5)).astype(np.float32)}


REF_SCRIPT = r"""
import json, os, sys
cfg = json.load(open(sys.argv[1]))
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=%d"
                           % max(int(p) for p in cfg["cases"]))
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core.collectives import algorithms as alg

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
out = {}
for p_str, cases in cfg["cases"].items():
    p = int(p_str)
    mesh = compat.mesh_from_devices(np.array(jax.devices()[:p]), ("x",))
    data = np.load(cfg["inputs"][p_str])
    perms = {k: [tuple(e) for e in v] for k, v in cfg["perms"][p_str].items()}
    for key, (op, name, segs, dt, inp) in cases.items():
        def body(xr, op=op, name=name, segs=segs):
            x = xr[0]
            if op == "ppermute":
                return jax.lax.ppermute(x, "x", perms[name])
            f = alg.get(op, name)
            if op == "barrier":
                return f("x", p)
            if op in ("all_reduce", "reduce_scatter", "reduce"):
                return f(x, "x", p, op="add", segments=segs)
            return f(x, "x", p, segments=segs)
        xs = jnp.asarray(data[inp], JDT[dt])
        got = jax.jit(compat.shard_map(
            lambda xr: body(xr).reshape(1, -1), mesh=mesh, in_specs=P("x"),
            out_specs=P("x"), check_vma=False))(xs)
        out[p_str + "|" + key] = np.asarray(got.astype(jnp.float32))
np.savez(cfg["out"], **out)
print("cases", len(out))
"""


def _port_sweep(cases, inputs_path, perms, out_dir):
    """Inside each rank of a p-process gloo group: every case on this
    rank's row of the inputs; outputs to ``port_r<rank>.npz``."""
    r, p = grp.rank(), grp.size()
    data = np.load(inputs_path)
    res = {}
    for key, (op, name, segs, dt, inp) in cases.items():
        x = torch.from_numpy(data[inp][r]).to(TDT[dt])
        if op == "ppermute":
            got = grp.ppermute(x, perms[name])
        else:
            f = talg.get(op, name)
            if op == "barrier":
                got = f(None, p)
            elif op in ("all_reduce", "reduce_scatter", "reduce"):
                got = f(x, None, p, op="add", segments=segs)
            else:
                got = f(x, None, p, segments=segs)
        res[key] = got.float().reshape(-1).numpy()
    np.savez(os.path.join(out_dir, f"port_r{r}.npz"), **res)


PS = (2, 3, 4, 5)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """{p: (cases, inputs, reference outputs (p, -1), port outputs per
    rank)}: the reference subprocess runs while the port's groups do."""
    tmp = tmp_path_factory.mktemp("collectives")
    cfg = {"cases": {}, "inputs": {}, "perms": {},
           "out": str(tmp / "ref.npz")}
    for p in PS:
        path = str(tmp / f"inputs_p{p}.npz")
        np.savez(path, **_inputs(p))
        cfg["cases"][str(p)] = _cases(p)
        cfg["inputs"][str(p)] = path
        cfg["perms"][str(p)] = _perms(p)
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "cfg.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = {}
    try:
        for p in PS:
            d = tmp / f"port_p{p}"
            d.mkdir()
            grp.spawn(_port_sweep, p, (_cases(p), cfg["inputs"][str(p)],
                                       _perms(p), str(d)))
            port[p] = [dict(np.load(d / f"port_r{r}.npz")) for r in range(p)]
        out, err = ref_proc.communicate(timeout=600)
    finally:
        ref_proc.kill()
    assert ref_proc.returncode == 0, out + err[-4000:]
    ref_out = dict(np.load(cfg["out"]))
    return {p: (_cases(p), _inputs(p),
                {k.split("|", 1)[1]: v for k, v in ref_out.items()
                 if k.split("|", 1)[0] == str(p)}, port[p]) for p in PS}


def _all_keys():
    return [(p, key) for p in PS for key in _cases(p)]


def _abs_sums(case, inputs, p):
    """sum_i |x_i| laid out as the op's per-rank output: the scale of the
    partial sums a reduction of the ranks' inputs forms."""
    op, name, segs, dt, inp = case
    s = torch.from_numpy(inputs[inp]).to(TDT[dt]).float().abs().sum(0)
    if op == "reduce_scatter":
        return torch.nn.functional.pad(s, (0, (-s.numel()) % p)) \
            .reshape(p, -1).numpy()
    return s.expand(p, -1).numpy()


@pytest.mark.parametrize("p,key", _all_keys())
def test_port_algorithm_matches_reference(sweep, p, key):
    cases, inputs, ref_out, port = sweep[p]
    case = cases[key]
    op, name, segs, dt, inp = case
    want = ref_out[key]
    got = np.stack([port[r][key] for r in range(p)])
    assert got.shape == want.shape, (got.shape, want.shape)
    if name != "xla":
        np.testing.assert_array_equal(got, want)     # the reference's bits
        return
    if op in ("all_gather", "all_to_all", "broadcast"):
        np.testing.assert_array_equal(got, want)     # moves, or adds zeros
        return
    # a backend's sum may take the ranks in another order
    if dt == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        # each of the p-1 bf16 roundings is within 2^-8 of a partial sum,
        # and every partial sum is within sum_i |x_i|
        bound = 2 * (p - 1) * 2.0 ** -8 * _abs_sums(case, inputs, p)
        assert (np.abs(got - want) <= bound).all()
    if op == "all_reduce":
        oracle = torch.from_numpy(inputs[inp]).to(TDT[dt]).float().sum(0)
        tol = (1e-6 if dt == "float32" else 2 ** -8 * (p - 1)) \
            * _abs_sums(case, inputs, p)
        assert (np.abs(got - oracle.numpy()) <= tol + 1e-6).all()


def test_ppermute_keeps_jax_semantics(sweep):
    """Zeros where a rank is no destination, send-only ranks, (i, i)
    copies: the port's outputs equal the reference's, and at p=4 the
    chain case gives exactly x0 at rank 1, x1 at rank 2, zeros elsewhere."""
    cases, inputs, ref_out, port = sweep[4]
    x = inputs["x"]
    got = np.stack([port[r]["ppermute|chain"] for r in range(4)])
    want = np.zeros_like(x)
    want[1], want[2] = x[0], x[1]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.stack([port[r]["ppermute|self"] for r in range(4)]), x)


def test_ppermute_rejects_duplicate_sources():
    with pytest.raises(ValueError, match="unique"):
        grp.ppermute(torch.ones(2), [(0, 1), (0, 2)])


# ---------------------------------------------------------------------------
# the tuning core: artifacts cross packages byte for byte
# ---------------------------------------------------------------------------
@pytest.fixture
def synth_fronts():
    """Both packages' synthesized fronts at p in {2, 4, 8}, cleared after."""
    ps = (2, 4, 8)
    fj = jsynth.synthesize_all(jtuning.OPS, ps)
    ft = tsynth.synthesize_all(ttuning.OPS, ps)
    yield fj, ft
    jsynth.clear_registry()
    tsynth.clear_registry()


def test_synthesized_fronts_match(synth_fronts):
    fj, ft = synth_fronts
    assert fj == ft and fj[("all_reduce", 4)]
    for (op, p) in fj:
        ej = jsynth.synthesize_front(op, p, register=False)
        et = tsynth.synthesize_front(op, p, register=False)
        assert [(e.program.to_json(), e.cost) for e in ej] == \
            [(e.program.to_json(), e.cost) for e in et]


@pytest.mark.parametrize("tuner", ["exhaustive", "thinned", "smgd"])
def test_simulator_tuned_tables_are_byte_identical(tuner, synth_fronts,
                                                   tmp_path):
    ops_, ps = jtuning.OPS, (2, 4, 8)
    ms = jtuning.MESSAGE_SIZES[::3]
    paths = {}
    for name, pkg in (("jax", jtuning), ("torch", ttuning)):
        sim = pkg.NetworkSimulator(pkg.NetworkProfile(seed=0))
        session = pkg.TuningSession(pkg.SimulatorBackend(sim), trials=2)
        rep = session.fit_all([pkg.make_tuner(tuner, ops_, ps, ms)])[0]
        paths[name] = tmp_path / f"{name}.json"
        rep.table.save(str(paths[name]))
        session.save_measurements(str(tmp_path / f"{name}_cache.json"))
    assert paths["jax"].read_bytes() == paths["torch"].read_bytes()
    assert json.loads(paths["torch"].read_text())["meta"]["programs"]
    assert (tmp_path / "jax_cache.json").read_bytes() == \
        (tmp_path / "torch_cache.json").read_bytes()


@pytest.mark.parametrize("writer,reader", [(jtuning, ttuning),
                                           (ttuning, jtuning)])
def test_session_cache_loads_in_the_other_package(writer, reader, tmp_path):
    sim = writer.NetworkSimulator(writer.NetworkProfile(seed=3))
    s = writer.TuningSession(writer.SimulatorBackend(sim), trials=2)
    s.fit_all([writer.make_tuner("exhaustive", ("all_reduce", "broadcast"),
                                 (2, 4), (4096, 1 << 20))])
    path = str(tmp_path / "cache.json")
    s.save_measurements(path)
    other = reader.TuningSession(trials=2)
    other.load_measurements(path)
    assert other._cache == s._cache and len(other) == len(s) > 0


def test_committed_artifact_resolves_the_same_method():
    path = os.path.join(ROOT, "examples", "artifacts", "tuned_decision.json")
    tj = jtuning.DecisionTable.load(path)
    tt = ttuning.DecisionTable.load(path)
    assert tj.meta.to_json() == tt.meta.to_json()
    points = list(tj.table)
    ops_ = sorted({o for o, _, _ in points})
    points += [(o, p, m) for o in ops_ for p in (1, 3, 6, 12, 100, 1000)
               for m in (1, 300, 5000, 3 << 20, 1 << 30)]
    for o, p, m in points:
        a, b = tj.decide(o, p, m), tt.decide(o, p, m)
        assert (a.algorithm, a.segments) == (b.algorithm, b.segments)


def test_only_ported_tuners_are_offered():
    """Every tuner family of the reference is ported, in its registry
    order, and an unknown name raises the reference's KeyError."""
    assert list(ttuning.TUNERS) == list(jtuning.TUNERS)
    assert len(ttuning.TUNERS) == 12
    for name in ttuning.TUNERS:
        assert ttuning.make_tuner(name).name == \
            jtuning.make_tuner(name).name
    with pytest.raises(KeyError) as et:
        ttuning.make_tuner("simplex")
    with pytest.raises(KeyError) as ej:
        jtuning.make_tuner("simplex")
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------
def test_measure_collectives_cpu_table_loads_in_the_reference(tmp_path):
    from repro_torch.launch import measure_collectives as mc
    out = str(tmp_path / "device_measured_decision.json")
    res = mc.main(["--device", "cpu", "--ranks", "2", "--sizes", "4096",
                   "65536", "--trials", "1", "--out", out, "--check",
                   "--grad-elems", "5000"])
    tj = jtuning.DecisionTable.load(out)
    assert tj.meta.backend == "DeviceBackend" and tj.meta.tuner == "exhaustive"
    assert sorted(tj.table) == [(op, 2, m) for op in ("all_reduce",
                                                      "broadcast")
                                for m in (4096, 65536)]
    for (op, _, m), meth in tj.table.items():
        best = [b for b in res["best"] if b[:2] == (op, m)][0]
        assert (meth.algorithm, meth.segments) == best[2:4]
    assert tj.meta.programs, "synthesized fronts ride in the artifact"
    assert max(res["check"]["max_abs_err"].values()) <= mc.TOL
    # the gradient goes through the Communicator built from the tuned
    # table (its choice at the gradient's size) and through "xla"
    variants = res["grad_sync"]["variants"]
    for label in ("per_leaf", "xla"):
        assert variants[label]["max_abs_err"] <= 1e-5
    meth = tj.decide("all_reduce", 2, 4 * 5000)
    assert variants["per_leaf"]["plan"] == {
        f"all_reduce/{meth.algorithm}/{meth.segments}/2": 1}
    # CPU tensors take the plain version: no kernel counts a launch
    assert res["launches"] == {"segment_combine": 0, "flash_attention": 0,
                               "ssd_chunk": 0}
    # per method: 2 sizes x (warm-up + 1 trial) in each of 2 ranks
    assert all(v == 2 * 2 * 2 for v in res["runs_by_method"].values())


def test_measure_collectives_needs_a_gpu_by_default():
    from repro_torch.launch import measure_collectives as mc
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mc.main(["--ranks", "2"])
