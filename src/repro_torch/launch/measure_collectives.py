"""Measure the port's collective algorithms for real, tune from the
measurements (port of ``examples/measure_real_collectives.py``), and
sync a gradient through the tuned `Communicator` (the gradient sync of
the reference's ``launch/train.py``, with its flags).

Spawns ``--ranks`` processes (or the product of ``--topology``) under
one ``gloo`` group. Each rank holds
its buffers on the card (``cuda:0``; ``--device cpu``: the host),
registers the synthesized schedule fronts at p = ranks, and runs the same
``TuningSession`` in lockstep: a ``DeviceBackend`` times every
(algorithm, segments) candidate of each op at each message size (a trial
is the slowest rank's time), and the tuner families ``--tuners`` names
(the exhaustive one by default) fit a ``DecisionTable`` each on those
measurements, over the one shared cache, as the reference's
``examples/autotune_collectives.py`` fits them over its simulator. Rank
0 prints the measured winners (op, bytes, winner, us) and, per family,
its new experiments, cache hits, empirical penalty, seconds and
``segment_combine`` launches, and saves the best table in the
reference's format, which ``repro.core.tuning.DecisionTable.load``
reads too.

Every reduce step on the card runs the hand-written ``segment_combine``
kernel. Payloads cross between the ranks through host memory
(``core/collectives/group.py``), so the times measure the schedules and
the host staging, not a GPU fabric.

Options beyond the reference's example:
  * ``--check``: before tuning, hold every algorithm of ``ALGORITHMS``
    and every synthesized program family at p against the oracle
    (sum, concatenation, root's value) at 4 MB and at an odd size;
  * the gradient sync, with ``--grad-arch ARCH`` (that model's whole
    parameter tree in the port's layout; ``--reduced`` for its reduced
    config) or ``--grad-elems N`` (one flat fp32 leaf); each rank draws
    its leaves from a seed. The mesh is ``--topology SPEC``'s (``2x2``:
    ``("pod", "data")``, ``2x2x2``: ``("dcn", "pod", "data")``) or one
    ``("data",)`` axis over ``--ranks``. The Communicator is built from
    ``--tuning-table PATH`` (and the tuning sweep is skipped) or from
    the best table just tuned; an artifact that carries a tuned mesh
    mapping rebuilds the mesh in the mapping's rank order, and the
    launcher reports the slot -> rank order it ran with. It syncs per
    leaf, bucketed (``--bucket-mb``, or the artifact's tuned schedule)
    and through ``"xla"`` (gloo's built-ins); each variant is held
    against the float64 oracle mean at ``GRAD_TOL``, its recorded spans
    against ``explain_gradients``, and timed (``GRAD_TRIALS`` runs, the
    slowest rank's seconds), with its ``segment_combine`` launches
    summed over the ranks beside the count its plan implies
    (`plan_combines`);
  * ``--probe-fabric``: probe every sync tier of the mesh and print the
    fitted (host-staged) profiles.

Examples:
    python -m repro_torch.launch.measure_collectives
    python -m repro_torch.launch.measure_collectives --device cpu \\
        --ranks 2 --sizes 4096 65536 --trials 1 --out /tmp/t.json
    python -m repro_torch.launch.measure_collectives --tuners all
    python -m repro_torch.launch.measure_collectives --topology 2x2 \\
        --tuning-table examples/artifacts/hierarchical_decision.json \\
        --grad-arch smollm-135m
"""
from __future__ import annotations

import argparse
import json
import time
from fractions import Fraction

import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.comms import Communicator
from repro_torch.comms.probe import describe_topology, probe_mesh_topology
from repro_torch.core.collectives import algorithms as alg
from repro_torch.core.collectives import group as grp
from repro_torch.core.collectives import synth
from repro_torch.core.collectives.dispatch import CollectiveSpec, \
    apply_collective
from repro_torch.core.collectives.hierarchical import multilevel_all_reduce
from repro_torch.core.topology import Topology
from repro_torch.core.tuning import TUNERS, TuningSession, make_tuner
from repro_torch.core.tuning.decision import rows_to_json
from repro_torch.core.tuning.executor import DeviceBackend
from repro_torch.kernels import attention, segment_reduce, ssd_scan
from repro_torch.obs import TraceRecorder

#: the reference example's message sizes plus 64 MB, the top of
#: ``MESSAGE_SIZES`` and a gradient bucket's size
SIZES = (4096, 262144, 4 << 20, 64 << 20)
OPS = ("all_reduce", "broadcast")
#: --check sizes in fp32 elements: 4 MB and an odd count
CHECK_ELEMS = (1 << 20, 262147)
TOL = 2e-5          # fp32, tests/helpers/validate_collectives.py
COUNTERS = {"segment_combine": segment_reduce, "flash_attention": attention,
            "ssd_chunk": ssd_scan}


def _zero_counts() -> None:
    for mod in COUNTERS.values():
        mod.launches = 0


def _counts() -> dict:
    return {name: mod.launches for name, mod in COUNTERS.items()}


def _sum_over_ranks(obj):
    """Gather a picklable count (int or dict of ints) from every rank and
    sum it key by key."""
    parts = [None] * grp.size()
    dist.all_gather_object(parts, obj)
    if isinstance(obj, dict):
        out = {}
        for part in parts:
            for k, v in part.items():
                out[k] = out.get(k, 0) + v
        return out
    return sum(parts)


def _inputs(n: int, p: int, device, seed: int):
    """Every rank's (n,) fp32 input, drawn from ``seed + rank`` on the
    device: each rank builds all of them, so it can form the oracle."""
    return [torch.randn((n,), device=device, generator=torch.Generator(
        device=device).manual_seed(seed + i)) for i in range(p)]


def _oracle_sum(xs):
    acc = xs[0].float()
    for x in xs[1:]:
        acc = acc + x.float()
    return acc


def _err(got, want) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite output")
    return (got.float() - want.float()).abs().max().item()


def check_algorithms(device) -> dict:
    """Run inside every rank: every algorithm of ``ALGORITHMS`` and every
    synthesized family at p against its oracle, fp32. Returns
    ``{"op/algorithm/n": max |err|}`` and the kernel launches of the
    run; raises (on every rank) if any case is off by more than 2e-5."""
    p, r = grp.size(), grp.rank()
    _zero_counts()
    errs = {}
    for n in CHECK_ELEMS:
        xs = _inputs(n, p, device, seed=n)
        x = xs[r]
        total = _oracle_sum(xs)
        pad = (-n) % p
        want = {
            "all_reduce": total,
            "reduce_scatter": torch.nn.functional.pad(total, (0, pad))
            .reshape(p, -1)[r],
            "all_gather": torch.cat(xs),
            "broadcast": xs[0],
        }
        cases = [(op, name) for op in want for name in alg.ALGORITHMS[op]]
        cases += [(op, "synth:" + name) for op in synth.PROGRAM_OPS
                  for name in sorted(synth.families(op, p))]
        for op, name in cases:
            got = apply_collective(op, x, None, p, CollectiveSpec(name, 1))
            errs[f"{op}/{name}/{n}"] = _err(got, want[op])
            if op == "all_reduce" and name == "ring":
                got = apply_collective(op, x, None, p, CollectiveSpec(name, 4))
                errs[f"{op}/{name}/s4/{n}"] = _err(got, want[op])
            if op == "broadcast" and name in ("chain", "pipelined_binary"):
                got = apply_collective(op, x, None, p, CollectiveSpec(name, 4))
                errs[f"{op}/{name}/s4/{n}"] = _err(got, want[op])
        if n % p == 0:                # all_to_all: rows for each rank
            m = n // p
            for name in alg.ALGORITHMS["all_to_all"]:
                got = alg.get("all_to_all", name)(x, None, p)
                want_a2a = torch.cat([xs[j][r * m:(r + 1) * m]
                                      for j in range(p)])
                errs[f"all_to_all/{name}/{n}"] = _err(got, want_a2a)
        got = alg.reduce_binomial(x, None, p, op="add")
        if r == 0:
            errs[f"reduce/binomial/at_rank0/{n}"] = _err(got, total)
    for name, fn in alg.ALGORITHMS["barrier"].items():
        tok = fn(None, p, device=device)
        errs[f"barrier/{name}"] = abs(tok.item() - (p if name == "linear"
                                                    else 0.0))
    bad = {k: v for k, v in errs.items() if not v <= TOL}
    worst = grp.max_over_ranks([max(errs.values())])[0]
    if worst > TOL:
        raise AssertionError(f"algorithms off the oracle by {worst} > "
                             f"{TOL} (rank {r}: {bad})")
    return {"max_abs_err": errs, "launches": _sum_over_ranks(_counts())}


# ---------------------------------------------------------------------------
# gradient sync through the Communicator
# ---------------------------------------------------------------------------
#: hierarchical sums against the float64 oracle mean
#: (tests/helpers/validate_communicator.py)
GRAD_TOL = 2e-4
#: timed runs of each gradient-sync variant, after its traced first run
#: (one, to keep chip_smoke.py's [6] and [7] inside its time limit)
GRAD_TRIALS = 1


def combines_per_rank(op: str, algorithm: str, segments: int, p: int
                      ) -> int:
    """``segment_combine`` calls one rank makes in one run of ``op`` by
    ``algorithm`` at fan-out p, from its schedule (the binomial reduce of
    ``reduce_bcast``: the mean over the p ranks, p-1 in all)."""
    k = p.bit_length() - 1
    if op not in ("all_reduce", "reduce_scatter") or p < 2 or \
            algorithm in ("xla", "allgather_reduce"):
        return 0
    if algorithm.startswith("synth:"):
        prog = synth._dispatch_program(op, algorithm[len("synth:"):], p)
        return sum(1 for st in prog.steps if st.reduce)
    per = {("all_reduce", "ring"): segments * (p - 1),
           ("all_reduce", "recursive_doubling"): k,
           ("all_reduce", "rabenseifner"): k,
           ("all_reduce", "reduce_bcast"): Fraction(p - 1, p),
           ("reduce_scatter", "ring"): p - 1,
           ("reduce_scatter", "recursive_halving"): k}
    if (op, algorithm) not in per:
        raise KeyError(f"no combine count for {op} {algorithm}")
    return per[(op, algorithm)]


def plan_combines(report, world: int) -> int:
    """``segment_combine`` launches that one run of a gradient-sync plan
    implies, summed over the ``world`` ranks: every entry runs in every
    rank (each in its own sub-group along the entry's axis)."""
    total = sum(combines_per_rank(e.request.op, e.spec.algorithm,
                                  e.spec.segments, e.request.axis_size)
                for e in report.entries)
    return int(total * world)


def mesh_spec(topology, ranks: int):
    """(shape, axis names) of the launch mesh: the topology's levels,
    outermost first, on the sync axes (``("pod", "data")`` for ``2x2``);
    without a topology one ``("data",)`` axis over the ranks."""
    if topology is None:
        return (ranks,), ("data",)
    levels = list(reversed(topology.levels))
    return tuple(lv.size for lv in levels), tuple(lv.axis for lv in levels)


def _gradient_structure(arch, reduced, n, device, layers=None):
    """Shapes of the synced gradient: ``arch``'s parameter tree in the
    port's layout (per-layer dicts; ``layers``: its depth cut to that
    many layers), or one flat (n,) leaf."""
    if not arch:
        return {"grad": pytree.LeafStruct((n,), torch.float32)}
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = cfg.replace(num_layers=layers)
    with torch.inference_mode():
        params = build_model(cfg, device=device.type).init(
            torch.Generator(device=device).manual_seed(0))
    struct = pytree.tree_map(
        lambda t: pytree.LeafStruct(tuple(t.shape), torch.float32), params)
    del params
    return struct


def _draw(struct, device, seed: int, r: int):
    """Rank r's gradient: every leaf from N(0, 1), drawn in tree order
    from one generator seeded by (seed, r), on the device."""
    gen = torch.Generator(device=device).manual_seed(seed * 100003 + r)
    return pytree.tree_map(lambda s: torch.randn(
        s.shape, generator=gen, device=device, dtype=s.dtype), struct)


def _oracle_err(out, struct, device, seed: int, p: int) -> float:
    """max |out - mean over ranks| with the mean in float64, leaf by
    leaf: each rank's leaves are drawn again from its generator."""
    gens = [torch.Generator(device=device).manual_seed(seed * 100003 + j)
            for j in range(p)]
    err = 0.0
    for got, s in zip(pytree.leaves(out), pytree.leaves(struct)):
        acc = torch.zeros(s.shape, dtype=torch.float64, device=device)
        for g in gens:
            acc += torch.randn(s.shape, generator=g, device=device,
                               dtype=s.dtype).double()
        if tuple(got.shape) != tuple(s.shape) or not \
                torch.isfinite(got).all():
            raise AssertionError(f"leaf {tuple(got.shape)} off its "
                                 f"shape {s.shape} or not finite")
        if got.numel():
            err = max(err, (got.double() - acc / p).abs().max().item())
    return err


def _max_diff(a, b) -> float:
    return max(((x.double() - y.double()).abs().max().item()
                for x, y in zip(pytree.leaves(a), pytree.leaves(b))
                if x.numel()), default=0.0)


def _bits_equal(a, b) -> bool:
    return all(torch.equal(x, y)
               for x, y in zip(pytree.leaves(a), pytree.leaves(b)))


def _plan_counts(report) -> dict:
    """The plan's entries counted by ``op/algorithm/segments/p``."""
    out = {}
    for e in report.entries:
        key = (f"{e.request.op}/{e.spec.algorithm}/{e.spec.segments}/"
               f"{e.request.axis_size}")
        out[key] = out.get(key, 0) + 1
    return out


def _spans_match(report, spans) -> bool:
    """The plan's dispatched entries (every entry but the flat path's
    psum tops) equal the recorded spans, entry for entry."""
    planned = [(e.request.op, e.request.nbytes, e.request.axis,
                e.request.axis_size, e.spec.algorithm, e.spec.segments,
                e.bucket, e.step)
               for e in report.entries if e.source != "psum"]
    recorded = [(s.op, s.nbytes, s.axis, s.axis_size, s.algorithm,
                 s.segments, s.bucket, s.step) for s in spans]
    return planned == recorded


def _bucket_check(comm, grads, out) -> list:
    """Each fusion bucket of the bucketed sync's result against its own
    sequential composition (``multilevel_all_reduce``, psum tops for a
    flat policy, the mean): [bit-equal?] per bucket."""
    layout, active, _, axes, _, keys, hier = comm._bucket_plan(
        grads, comm.bucket_bytes)
    flats_in, flats_out = layout.flatten(grads), layout.flatten(out)
    denom = comm._data_parallel_size()
    equal = []
    for i in active:
        seq = multilevel_all_reduce(flats_in[i], comm._levels_for(axes),
                                    comm, level_keys=keys)
        if not hier:
            for outer in comm._sync_axes[1:]:
                seq = grp.psum(seq, comm.mesh.axis(outer))
        equal.append(torch.equal(seq / denom, flats_out[i]))
    return equal


def _slots(mesh) -> list:
    """The rank at each flat mesh slot, as the ranks see it: each rank
    gathers its index along every axis (``group.rank``), so a slot
    holds the rank whose indices name it."""
    coords = [grp.rank(mesh.axis(a)) for a in mesh.axis_names]
    parts = [None] * grp.size()
    dist.all_gather_object(parts, coords)
    slots = [None] * grp.size()
    for r, c in enumerate(parts):
        i = 0
        for a, k in zip(mesh.axis_names, c):
            i = i * mesh.shape[a] + k
        slots[i] = r
    return slots


def grad_sync(mesh, artifact, struct, device, *, bucket_bytes=None,
              trials: int = GRAD_TRIALS, seed: int = 1) -> dict:
    """Run inside every rank: sync this rank's gradient (``struct``'s
    shapes, drawn from (seed, rank)) through the Communicator built from
    ``artifact`` on ``mesh``, per leaf, bucketed (when the artifact's
    schedule or ``bucket_bytes`` gives a budget) and through ``"xla"``.
    Each variant's first run records its spans (rank 0 reports their
    seconds by op and axis beside the run's wall time) and is held
    against the float64 oracle mean and its plan; then ``trials`` timed runs
    (barrier, run, synchronize; the slowest rank's time), the first of
    which must give the recorded run's bits. The bucketed variant's
    buckets are held bit-equal to their sequential compositions and its
    result to the per-leaf one."""
    p = grp.size()
    grads = _draw(struct, device, seed, grp.rank())
    comm = Communicator.create(mesh, artifact=artifact,
                               bucket_bytes=bucket_bytes)
    # an artifact's tuned mapping rebuilt the mesh: every variant runs on
    # the rebuilt one
    variants = {"per_leaf": Communicator.create(comm.mesh, artifact=artifact,
                                                bucket_bytes=0)}
    if comm.bucket_bytes:
        variants["bucketed"] = comm
    variants["xla"] = Communicator.create(comm.mesh)
    leaves = pytree.leaves(grads)
    out = {"elems": sum(t.numel() for t in leaves), "leaves": len(leaves),
           "bytes": sum(t.numel() * t.element_size() for t in leaves),
           "mesh": dict(mesh.shape), "describe": comm.describe(),
           "mapping": comm.mapping.to_json() if comm.mapping else None,
           "slots": _slots(comm.mesh), "variants": {}}
    kept = None
    for label, c in variants.items():
        plan = c.explain_gradients(grads)
        v = {"describe": c.describe(), "bucket_bytes": c.bucket_bytes,
             "plan_entries": len(plan), "plan": _plan_counts(plan),
             "plan_combines": plan_combines(plan, p), "runs": 1 + trials}
        _zero_counts()
        c.trace = TraceRecorder()
        t0 = time.perf_counter()
        recorded = c.sync_gradients(grads)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        v["recorded_s"] = time.perf_counter() - t0
        spans = c.trace.collective_spans()
        c.trace = None
        # where this rank's recorded run went, by op and axis
        v["span_s"] = {}
        for sp in spans:
            key = f"{sp.op}@{sp.axis}"
            v["span_s"][key] = v["span_s"].get(key, 0.0) + sp.seconds
        times = []
        for i in range(trials):
            grp.barrier()
            t0 = time.perf_counter()
            res = c.sync_gradients(grads)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
            if i == 0:
                v["trace_bits_equal"] = grp.max_over_ranks(
                    [float(not _bits_equal(res, recorded))])[0] == 0
            del res
        v["launches"] = _sum_over_ranks(_counts())
        v["seconds"] = grp.max_over_ranks(times)
        v["spans"] = len(spans)
        v["plan_matches_spans"] = _spans_match(plan, spans)
        v["max_abs_err"] = grp.max_over_ranks(
            [_oracle_err(recorded, struct, device, seed, p)])[0]
        if label == "bucketed":
            eq = _bucket_check(c, grads, recorded)
            v["buckets"] = len(eq)
            v["buckets_bit_equal"] = -int(grp.max_over_ranks(
                [-sum(eq)])[0])
            v["vs_per_leaf_max_abs"] = grp.max_over_ranks(
                [_max_diff(recorded, kept)])[0]
            kept = None
        if label == "per_leaf" and "bucketed" in variants:
            kept = recorded
        del recorded
        ok = (v["max_abs_err"] <= GRAD_TOL and v["plan_matches_spans"]
              and v["trace_bits_equal"]
              and v.get("buckets_bit_equal", 0) == v.get("buckets", 0)
              and v.get("vs_per_leaf_max_abs", 0.0) <= GRAD_TOL)
        if not ok:
            raise AssertionError(f"gradient sync {label} failed its "
                                 f"checks: {v}")
        out["variants"][label] = v
    return out


class _Counted:
    """A tuner whose fit is bracketed by the launch counts: zeroed just
    before it, read just after, with the backend's runs and launches by
    (op, algorithm, segments) that the fit added (its fresh samples)."""

    def __init__(self, tuner, backend: DeviceBackend):
        self.tuner, self.backend = tuner, backend
        self.name = tuner.name

    def fit(self, session):
        runs0, launches0 = dict(self.backend.runs), \
            dict(self.backend.launches)
        _zero_counts()
        table = self.tuner.fit(session)
        self.launches = _counts()

        def added(now, before):
            return {"/".join(map(str, k)): v - before.get(k, 0)
                    for k, v in now.items() if v != before.get(k, 0)}
        self.runs = added(self.backend.runs, runs0)
        self.launches_by_method = added(self.backend.launches, launches0)
        return table


def _table_text(table) -> str:
    """A table's artifact JSON (meta and rows), for comparing ranks."""
    return json.dumps({"meta": table.meta.to_json() if table.meta else None,
                       "rows": rows_to_json(table.table)}, sort_keys=True)


def tune(device, tuners, sizes, trials: int) -> dict:
    """Run inside every rank: fit each of ``tuners`` (registry names)
    over one measured `TuningSession` at p = ranks, the ops ``OPS`` at
    ``sizes``. Returns the best report's table and, per family, its
    report and launch counts summed over the ranks, and whether every
    rank ended with the same table."""
    p = grp.size()
    fronts = synth.synthesize_all(OPS, (p,))
    backend = DeviceBackend(device=device)
    session = TuningSession(backend, trials=trials)
    counted = [_Counted(make_tuner(n, OPS, (p,), sizes), backend)
               for n in tuners]
    t0 = time.perf_counter()
    reps = session.fit_all(counted)
    out = {"tune_seconds": time.perf_counter() - t0, "families": []}
    total = {}
    for c, rep in zip(counted, reps):
        launches = _sum_over_ranks(c.launches)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        texts = [None] * p
        dist.all_gather_object(texts, _table_text(rep.table))
        out["families"].append(dict(
            name=rep.name, n_experiments=rep.n_experiments,
            n_requested=rep.n_requested, cache_hits=rep.cache_hits,
            penalty=rep.penalty, seconds=rep.fit_seconds,
            launches=launches,
            launches_by_method=_sum_over_ranks(c.launches_by_method),
            runs_by_method=_sum_over_ranks(c.runs),
            same_table_on_every_rank=len(set(texts)) == 1))
    best = TuningSession.best(reps)
    out.update(
        report=best, launches=total,
        launches_by_method=_sum_over_ranks(
            {"/".join(map(str, k)): v for k, v in backend.launches.items()}),
        runs_by_method=_sum_over_ranks(
            {"/".join(map(str, k)): v for k, v in backend.runs.items()}),
        fronts={f"{op}@{q}": list(v) for (op, q), v in fronts.items()},
        samples=len(session), n_experiments=session.n_experiments,
        best=[(op, m, meth.algorithm, meth.segments, t)
              for (op, _, m), (meth, t) in sorted(
                  session.dataset().best().items())],
        means={"/".join(map(str, k)): t for k, t in
               session.dataset().mean_times().items()})
    return out


def _rank_main(opts: dict):
    """The whole run inside one rank; rank 0's return value is the
    result."""
    device = grp.device_of(opts["device"])
    p = grp.size()
    res = {"ranks": p, "device": str(device),
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")}
    if opts["check"]:
        res["check"] = check_algorithms(device)

    artifact = opts["tuning_table"]
    if artifact is None:
        tuned = tune(device, opts["tuners"], opts["sizes"], opts["trials"])
        rep = tuned.pop("report")
        artifact = rep.table
        res.update(tuned)
        if grp.rank() == 0:
            rep.table.save(opts["out"])
            res.update(tuner=rep.name, penalty=rep.penalty,
                       backend=rep.table.meta.backend, out=opts["out"])
    if opts["grad_arch"] or opts["grad_elems"]:
        mesh = grp.RankMesh(opts["mesh_shape"], opts["mesh_axes"],
                            device=device)
        if opts["probe_fabric"]:
            res["probed"] = describe_topology(probe_mesh_topology(mesh))
        struct = _gradient_structure(opts["grad_arch"], opts["reduced"],
                                     opts["grad_elems"], device,
                                     opts["grad_layers"])
        res["grad_sync"] = grad_sync(
            mesh, artifact, struct, device, bucket_bytes=opts["bucket_bytes"],
            trials=GRAD_TRIALS)
        res["grad_sync"]["arch"] = opts["grad_arch"]
        res["grad_sync"]["artifact"] = opts["tuning_table"] or "tuned"
    return res if grp.rank() == 0 else None


def _percent(penalty) -> str:
    """A penalty as a percentage; None (no decision could be scored)
    as such."""
    return "none" if penalty is None else f"{penalty * 100:.2f}%"


def print_table(res: dict) -> None:
    where = res["device_name"] + (", payloads staged through the host"
                                  if res["device"].startswith("cuda") else "")
    if "best" in res:
        print(f"measured {res['samples']} samples on {res['ranks']} ranks "
              f"({where}; {res['n_experiments']} experiments)")
        print(f"{'op':12s} {'bytes':>9s} {'winner':>22s} {'us':>9s}")
        for op, m, a, s, t in res["best"]:
            print(f"{op:12s} {m:9d} {a:>18s}/s{s} {t * 1e6:9.1f}")
        print(f"{'tuner':14s} {'new exps':>9s} {'cache hits':>11s} "
              f"{'penalty':>8s} {'seconds':>8s} {'combines':>9s}")
        for f in res["families"]:
            print(f"{f['name']:14s} {f['n_experiments']:9d} "
                  f"{f['cache_hits']:11d} {_percent(f['penalty']):>8s} "
                  f"{f['seconds']:8.2f} "
                  f"{f['launches']['segment_combine']:9d}")
        print(f"-> {res['out']} (best: {res['tuner']}, penalty "
              f"{_percent(res['penalty'])}, backend={res['backend']})")
    if "probed" in res:
        print(res["probed"])
    gs = res.get("grad_sync")
    if gs:
        print(f"gradient sync on {res['ranks']} ranks ({where}), mesh "
              f"{gs['mesh']}, {gs['leaves']} leaves, {gs['elems']} fp32 "
              f"elements ({gs['bytes'] / 1e6:.1f} MB), artifact "
              f"{gs['artifact']}: {gs['describe']}")
        if gs["mapping"]:
            print(f"  mesh remapped by the artifact: slot -> rank "
                  f"{gs['slots']}")
        for label, v in gs["variants"].items():
            print(f"  {label:9s} {v['plan_entries']:6d} entries, s per "
                  f"trial {' '.join(f'{t:.4f}' for t in v['seconds'])}, "
                  f"max|err| vs the float64 mean {v['max_abs_err']:.3g}, "
                  f"segment_combine {v['launches']['segment_combine']} "
                  f"launches over {v['runs']} runs (plan: "
                  f"{v['plan_combines']} a run); rank 0's traced run "
                  f"{v['recorded_s']:.4f} s, in collectives "
                  + ", ".join(f"{k} {t:.4f}" for k, t in
                              sorted(v["span_s"].items())))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks without --topology")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--sizes", nargs="+", type=int, default=list(SIZES),
                    help="message sizes in bytes")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default="device_measured_decision.json",
                    help="where the best tuner's table is saved")
    ap.add_argument("--tuners", default="exhaustive",
                    help="tuner families to fit over the measured "
                         "session: comma-separated names of "
                         "core.tuning.TUNERS, or 'all'")
    ap.add_argument("--check", action="store_true",
                    help="hold every algorithm against the oracle first")
    ap.add_argument("--tuning-table", default=None,
                    help="build the Communicator from this artifact and "
                         "skip the tuning sweep")
    ap.add_argument("--topology", default=None,
                    help="mesh spec, outermost first (2x2, 2x2x2): the "
                         "ranks are its product, the axes the sync tiers")
    ap.add_argument("--bucket-mb", type=float, default=None,
                    help="fusion-bucket budget for the bucketed sync "
                         "(default: the artifact's tuned schedule)")
    ap.add_argument("--grad-arch", default=None,
                    help="sync this model's whole gradient tree")
    ap.add_argument("--reduced", action="store_true",
                    help="with --grad-arch: the model's reduced config")
    ap.add_argument("--grad-layers", type=int, default=None,
                    help="with --grad-arch: the model cut to this many "
                         "layers (its widths kept)")
    ap.add_argument("--grad-elems", type=int, default=0,
                    help="sync one flat gradient of this many fp32 "
                         "elements (without --grad-arch)")
    ap.add_argument("--probe-fabric", action="store_true",
                    help="probe every sync tier of the mesh and print "
                         "the fitted profiles")
    args = ap.parse_args(argv)
    tuners = list(TUNERS) if args.tuners == "all" else \
        [n.strip() for n in args.tuners.split(",") if n.strip()]
    for n in tuners:
        if n not in TUNERS:
            raise KeyError(f"unknown tuner {n!r}; have {sorted(TUNERS)}")
    topology = Topology.from_spec(args.topology) if args.topology else None
    ranks = topology.total_size if topology else args.ranks
    shape, axes = mesh_spec(topology, ranks)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run "
                               "the ranks on the host")
        from repro_torch.kernels import _build
        _build.build_all()      # once, before the ranks load it
    opts = dict(
        device=args.device, check=args.check, sizes=tuple(args.sizes),
        trials=args.trials, out=args.out, tuning_table=args.tuning_table,
        tuners=tuners,
        mesh_shape=shape, mesh_axes=axes,
        bucket_bytes=None if args.bucket_mb is None
        else int(args.bucket_mb * (1 << 20)),
        grad_arch=args.grad_arch, reduced=args.reduced,
        grad_elems=args.grad_elems, grad_layers=args.grad_layers,
        probe_fabric=args.probe_fabric)
    res = grp.spawn(_rank_main, ranks, (opts,))
    print_table(res)
    return res


if __name__ == "__main__":
    main()
