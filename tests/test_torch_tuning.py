"""The port's tuner families against the JAX package's.

The nine families beyond the exhaustive, thinned and SMGD sweeps
(regression, ANN, bagged ensemble, C4.5 tree, quad/oct-tree, STAR,
feedback control, UMTAC) and their numpy helpers are copies of the
reference's modules, so on the same `NetworkSimulator` profile both
packages must write the same artifact byte for byte and report the same
cost (new experiments, cache hits) and empirical penalty. Held over a
small grid per family, over the reference example's full grid
(``examples/autotune_collectives.py``: every family in one
``fit_all``), and over the one-fan-out grid the card's measured session
has (p = 4, all_reduce and broadcast at the launcher's sizes). The
helpers are held bit for bit on numpy inputs drawn from a seed.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import tuning as jtuning  # noqa: E402
from repro.core.collectives import synth as jsynth  # noqa: E402
from repro.core.tuning import ann as jann  # noqa: E402
from repro.core.tuning import ensemble as jens  # noqa: E402
from repro.core.tuning import preprocess as jpre  # noqa: E402
from repro.core.tuning import regression as jreg  # noqa: E402
from repro.core.tuning import umtac as jumtac  # noqa: E402
from repro_torch.core import tuning as ttuning  # noqa: E402
from repro_torch.core.collectives import synth as tsynth  # noqa: E402
from repro_torch.core.tuning import ann as tann  # noqa: E402
from repro_torch.core.tuning import ensemble as tens  # noqa: E402
from repro_torch.core.tuning import preprocess as tpre  # noqa: E402
from repro_torch.core.tuning import regression as treg  # noqa: E402
from repro_torch.core.tuning import umtac as tumtac  # noqa: E402

NEW_FAMILIES = ("regression", "ann", "ensemble", "decision_tree", "quadtree",
                "octree", "star", "feedback", "umtac")
# examples/autotune_collectives.py's grid
EX_OPS = ("all_reduce", "all_gather", "all_to_all")
EX_PS = (4, 16, 64, 256)
EX_MS = tuple(sorted(set(1024 * 4 ** i for i in range(7))
                     | set(jtuning.DECODE_MESSAGE_SIZES)))
# the card's measured session (launch/measure_collectives.py at 4 ranks)
CARD_OPS = ("all_reduce", "broadcast")
CARD_MS = (4096, 262144, 4 << 20, 64 << 20)


@pytest.fixture(autouse=True)
def empty_synth_registries():
    """Both packages' synthesized-program registries empty for the test
    and put back after it: programs another test in this process
    registered would ride in one package's artifacts only."""
    saved = [(m, {k: dict(v) for k, v in m._REGISTRY.items()},
              dict(m._FRONTS)) for m in (jsynth, tsynth)]
    for m, _, _ in saved:
        m.clear_registry()
    yield
    for m, reg, fronts in saved:
        m._REGISTRY.clear()
        m._REGISTRY.update(reg)
        m._FRONTS.clear()
        m._FRONTS.update(fronts)


@pytest.fixture
def fronts():
    """Both packages' synthesized fronts at the example's fan-outs,
    cleared after."""
    ps = (2,) + EX_PS
    fj = jsynth.synthesize_all(EX_OPS, ps)
    ft = tsynth.synthesize_all(EX_OPS, ps)
    assert fj == ft
    yield
    jsynth.clear_registry()
    tsynth.clear_registry()


def _fit(pkg, names, ops, ps, ms, tmp_path, trials=3):
    """Fit ``names`` in one session of ``pkg`` on the seed-0 simulator;
    returns per family (artifact bytes, experiments, hits, penalty) and
    the session's measurement cache bytes."""
    sim = pkg.NetworkSimulator(pkg.NetworkProfile(seed=0))
    session = pkg.TuningSession(pkg.SimulatorBackend(sim), trials=trials)
    reps = session.fit_all([pkg.make_tuner(n, ops, ps, ms) for n in names])
    out = []
    for rep in reps:
        path = tmp_path / f"{pkg.__name__}_{rep.name}.json"
        rep.table.save(str(path))
        out.append((rep.name, path.read_bytes(), rep.n_experiments,
                    rep.n_requested, rep.cache_hits, rep.penalty))
    cache = tmp_path / f"{pkg.__name__}_cache.json"
    session.save_measurements(str(cache))
    return out, cache.read_bytes()


def _assert_same(names, ops, ps, ms, tmp_path):
    got_j, cache_j = _fit(jtuning, names, ops, ps, ms, tmp_path)
    got_t, cache_t = _fit(ttuning, names, ops, ps, ms, tmp_path)
    assert [g[0] for g in got_t] == list(names)
    for j, t in zip(got_j, got_t):
        assert t[1] == j[1], f"{t[0]}: artifact differs"
        assert t[2:] == j[2:], f"{t[0]}: cost or penalty differs"
        assert json.loads(t[1])["meta"]["tuner"] == t[0]
    assert cache_t == cache_j
    return got_t


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_family_alone_writes_the_reference_artifact(name, tmp_path):
    got = _assert_same([name], ("all_reduce", "all_gather"), (4, 16),
                       (1024, 16384, 262144, 4 << 20), tmp_path)
    (_, _, n_exp, _, hits, penalty), = got
    assert penalty is not None
    if name in ("star", "feedback"):
        assert n_exp > 0 and hits == 0          # fresh samples only
    else:
        assert n_exp > 0                        # alone: it measures


def test_every_family_over_the_example_grid(fronts, tmp_path):
    """The reference example's run: all twelve families over one shared
    cache, the synthesized fronts registered."""
    names = list(jtuning.TUNERS)
    got = _assert_same(names, EX_OPS, EX_PS, EX_MS, tmp_path)
    by = {g[0]: g for g in got}
    # the refit families ride the exhaustive sweep's probes
    for name in ("regression", "ann", "ensemble", "decision_tree",
                 "quadtree", "octree", "umtac"):
        assert by[name][2] == 0 and by[name][4] > 0, name
    assert by["feedback"][2] > 0 and by["star"][2] > 0
    assert json.loads(by["umtac"][1])["meta"]["programs"]


def test_every_family_over_the_cards_one_fan_out_grid(tmp_path):
    """p = 4 only, the launcher's ops and sizes: the grid every family
    fits from the card's measurements."""
    got = _assert_same(list(jtuning.TUNERS), CARD_OPS, (4,), CARD_MS,
                       tmp_path)
    for name, art, n_exp, _, hits, penalty in got:
        rows = json.loads(art)["rows"]
        assert {(r["op"], r["p"], r["m"]) for r in rows} == \
            {(o, 4, m) for o in CARD_OPS for m in CARD_MS}, name
        assert penalty is not None and penalty >= 0.0


# ---------------------------------------------------------------------------
# the numpy helpers, bit for bit
# ---------------------------------------------------------------------------
def _xy(seed, n=48, d=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.1, 100.0, size=d)
    y = np.exp(rng.normal(size=n)) * 1e-4
    return X, y


def test_standardizer_and_outlier_rejection_are_bit_equal():
    X, y = _xy(0)
    X[:, 2] = 3.0                                  # a constant column
    sj, st = jpre.fit_standardizer(X), tpre.fit_standardizer(X)
    np.testing.assert_array_equal(st.mu, sj.mu)
    np.testing.assert_array_equal(st.sigma, sj.sigma)
    np.testing.assert_array_equal(st.transform(X), sj.transform(X))
    np.testing.assert_array_equal(st.inverse(st.transform(X)),
                                  sj.inverse(sj.transform(X)))
    Xd = np.repeat(X[:8], 6, axis=0)               # repeated trials
    yd = np.repeat(y[:8], 6) * np.exp(np.random.default_rng(1).normal(
        scale=0.05, size=48))
    yd[::7] *= 50.0                                # outliers
    for z in (1.0, 2.0, 4.0):
        a, b = jpre.reject_outliers(Xd, yd, z=z), tpre.reject_outliers(
            Xd, yd, z=z)
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
        assert b[2] == a[2]


def test_regression_features_and_fit_are_bit_equal():
    for p, m, seg in ((2, 1024, 1), (64, 4 << 20, 8), (256, 7, 2)):
        np.testing.assert_array_equal(treg.expand_features(p, m, seg),
                                      jreg.expand_features(p, m, seg))
    rng = np.random.default_rng(2)
    X = np.stack([jreg.expand_features(int(p), int(m), int(s)) for p, m, s
                  in zip(rng.choice([2, 4, 16, 64], 40),
                         rng.choice([1024, 65536, 1 << 22], 40),
                         rng.choice([1, 2, 4], 40))])
    y = np.exp(rng.normal(size=40)) * 1e-3
    mj, mt = jreg.fit_linear(X, y, lam=1e-3), treg.fit_linear(X, y,
                                                              lam=1e-3)
    np.testing.assert_array_equal(mt.predict(X), mj.predict(X))
    assert treg.sparsity(mt) == jreg.sparsity(mj)


def _dataset(pkg):
    sim = pkg.NetworkSimulator(pkg.NetworkProfile(seed=0))
    session = pkg.TuningSession(pkg.SimulatorBackend(sim), trials=2)
    session.fit_all([pkg.make_tuner("exhaustive", ("all_reduce",), (4, 16),
                                    (1024, 65536, 1 << 20))],
                    evaluate=False)
    return session.dataset()


def test_ann_predictions_are_bit_equal():
    aj = jann.ANNSelector.fit(_dataset(jtuning), hidden=6, epochs=200,
                              seed=3)
    at = tann.ANNSelector.fit(_dataset(ttuning), hidden=6, epochs=200,
                              seed=3)
    for algo in ("ring", "recursive_doubling", "rabenseifner"):
        for p, m, seg in ((4, 1024, 1), (16, 1 << 20, 4), (8, 5000, 2)):
            assert at.predict_time("all_reduce", algo, p, m, seg) == \
                aj.predict_time("all_reduce", algo, p, m, seg)
    for p, m in ((4, 1024), (16, 1 << 20), (64, 3 << 20)):
        mt, mj = at.decide("all_reduce", p, m), aj.decide("all_reduce", p, m)
        assert (mt.algorithm, mt.segments) == (mj.algorithm, mj.segments)


def test_bagged_ensemble_is_bit_equal():
    X, y = _xy(4, n=40, d=6)
    for members in (1, 6):
        bj = jens.bag(X, y, n_members=members, iters=300, seed=5)
        bt = tens.bag(X, y, n_members=members, iters=300, seed=5)
        np.testing.assert_array_equal(bt.predict(X), bj.predict(X))


def test_profile_from_gradients_walks_the_tree_as_jax():
    """Leaves in ``jax.tree``'s order (dict keys sorted), bytes from
    numel and element size, bf16 included."""
    import jax.numpy as jnp

    def tree(make):
        return {"z": {"w": make((33, 7), "f"), "a": make((5,), "h")},
                "b": [make((3, 5), "f"), make((7,), "h")],
                "a": make((2, 3, 4), "f")}
    jt = tree(lambda s, k: jnp.zeros(s, jnp.float32 if k == "f"
                                     else jnp.bfloat16))
    tt = tree(lambda s, k: torch.zeros(s, dtype=torch.float32 if k == "f"
                                       else torch.bfloat16))
    pj = jumtac.profile_from_gradients(jt, axis_size=4)
    pt = tumtac.profile_from_gradients(tt, axis_size=4)
    assert [vars(p) for p in pt] == [vars(p) for p in pj]
    assert [p.message_bytes for p in pt] == [96, 15 * 4, 14, 5 * 2,
                                             231 * 4]


# ---------------------------------------------------------------------------
# the entry point: every family over one measured session, on the host
# ---------------------------------------------------------------------------
def test_measure_collectives_fits_every_family_from_measurements(tmp_path):
    from repro_torch.launch import measure_collectives as mc
    out = str(tmp_path / "measured.json")
    res = mc.main(["--device", "cpu", "--ranks", "2", "--sizes", "4096",
                   "65536", "--trials", "1", "--tuners", "all", "--out",
                   out])
    fams = res["families"]
    assert [f["name"] for f in fams] == list(ttuning.TUNERS)
    for f in fams:
        assert f["same_table_on_every_rank"], f["name"]
        assert f["penalty"] is not None and f["seconds"] >= 0.0
        # host tensors take the plain combine: no launch is counted
        assert f["launches"] == {"segment_combine": 0, "flash_attention": 0,
                                 "ssd_chunk": 0}
        if f["n_experiments"] == 0:
            assert not f["runs_by_method"], f["name"]
    by = {f["name"]: f for f in fams}
    assert by["exhaustive"]["n_experiments"] > 0
    for name in ("regression", "ann", "ensemble", "decision_tree",
                 "quadtree", "octree", "umtac"):
        assert by[name]["n_experiments"] == 0, name
    for name in ("star", "feedback"):
        assert by[name]["n_experiments"] > 0
        assert sum(by[name]["runs_by_method"].values()) == \
            2 * by[name]["n_experiments"]        # one run a rank a sample
    saved = jtuning.DecisionTable.load(out)
    assert saved.meta.tuner == res["tuner"] and \
        saved.meta.backend == "DeviceBackend"
    with pytest.raises(KeyError, match="unknown tuner"):
        mc.main(["--device", "cpu", "--tuners", "exhaustive,simplex"])
