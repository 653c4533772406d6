"""Measure the port's collective algorithms for real and tune from the
measurements (port of ``examples/measure_real_collectives.py``).

Spawns ``--ranks`` processes under one ``gloo`` group. Each rank holds
its buffers on the card (``cuda:0``; ``--device cpu``: the host),
registers the synthesized schedule fronts at p = ranks, and runs the same
``TuningSession`` in lockstep: a ``DeviceBackend`` times every
(algorithm, segments) candidate of each op at each message size (a trial
is the slowest rank's time), and the exhaustive tuner fits a
``DecisionTable`` on those measurements. Rank 0 prints the measured
winners (op, bytes, winner, us) and saves the table in the reference's
format, which ``repro.core.tuning.DecisionTable.load`` reads too.

Every reduce step on the card runs the hand-written ``segment_combine``
kernel. Payloads cross between the ranks through host memory
(``core/collectives/group.py``), so the times measure the schedules and
the host staging, not a GPU fabric.

Options beyond the reference's example:
  * ``--check``: before tuning, hold every algorithm of ``ALGORITHMS``
    and every synthesized program family at p against the oracle
    (sum, concatenation, root's value) at 4 MB and at an odd size;
  * ``--grad-elems N``: after tuning, all-reduce an N-element fp32
    gradient through the table's choice and through ``"xla"`` (the
    backend's all-reduce), each held against the oracle sum and timed.

Examples:
    python -m repro_torch.launch.measure_collectives
    python -m repro_torch.launch.measure_collectives --device cpu \\
        --ranks 2 --sizes 4096 65536 --trials 1 --out /tmp/t.json
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.core.collectives import algorithms as alg
from repro_torch.core.collectives import group as grp
from repro_torch.core.collectives import synth
from repro_torch.core.collectives.dispatch import CollectiveSpec, \
    apply_collective
from repro_torch.core.tuning import DecisionTable, TuningSession, make_tuner
from repro_torch.core.tuning.executor import DeviceBackend
from repro_torch.kernels import attention, segment_reduce, ssd_scan

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


def grad_sync(table: DecisionTable, n: int, device, trials: int = 3) -> dict:
    """Run inside every rank: all-reduce an n-element fp32 gradient
    through the table's choice at its size and through ``"xla"``; each is
    held against the oracle sum and timed like a probe (barrier, run,
    synchronize; the slowest rank's time)."""
    p, r = grp.size(), grp.rank()
    xs = _inputs(n, p, device, seed=1)
    want = _oracle_sum(xs)
    x = xs[r]
    del xs
    nbytes = 4 * n
    meth = table.decide("all_reduce", p, nbytes)
    out = {"elems": n, "bytes": nbytes}
    for label, spec in (("tuned", CollectiveSpec(meth.algorithm,
                                                 meth.segments)),
                        ("xla", CollectiveSpec("xla", 1))):
        _zero_counts()
        got = apply_collective("all_reduce", x, None, p, spec)
        err = grp.max_over_ranks([_err(got, want)])[0]
        if not err <= 1e-5 * (1 + want.abs().max().item()):
            raise AssertionError(f"{label} gradient all-reduce off the "
                                 f"oracle by {err}")
        del got
        times = []
        for _ in range(trials):
            grp.barrier()
            t0 = time.perf_counter()
            apply_collective("all_reduce", x, None, p, spec)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        out[label] = {"algorithm": spec.algorithm, "segments": spec.segments,
                      "max_abs_err": err, "runs": 1 + trials,
                      "seconds": grp.max_over_ranks(times),
                      "launches": _sum_over_ranks(_counts())}
    return out


def _rank_main(sizes, trials, out_path, device, check, grad_elems):
    """The whole run inside one rank; rank 0's return value is the
    result."""
    device = grp.device_of(device)
    p = grp.size()
    res = {"ranks": p, "device": str(device),
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")}
    if check:
        res["check"] = check_algorithms(device)

    fronts = synth.synthesize_all(OPS, (p,))
    backend = DeviceBackend(device=device)
    session = TuningSession(backend, trials=trials)
    _zero_counts()
    t0 = time.perf_counter()
    rep = session.fit_all([make_tuner("exhaustive", OPS, (p,), sizes)])[0]
    res["tune_seconds"] = time.perf_counter() - t0
    res["launches"] = _sum_over_ranks(_counts())
    res["launches_by_method"] = _sum_over_ranks(
        {"/".join(map(str, k)): v for k, v in backend.launches.items()})
    res["runs_by_method"] = _sum_over_ranks(
        {"/".join(map(str, k)): v for k, v in backend.runs.items()})
    if grad_elems:
        res["grad_sync"] = grad_sync(rep.table, grad_elems, device)
    if grp.rank() != 0:
        return None
    rep.table.save(out_path)
    res.update(
        fronts={f"{op}@{q}": list(v) for (op, q), v in fronts.items()},
        samples=len(session), n_experiments=rep.n_experiments,
        penalty=rep.penalty, backend=rep.table.meta.backend,
        out=out_path,
        best=[(op, m, meth.algorithm, meth.segments, t)
              for (op, _, m), (meth, t) in sorted(
                  session.dataset().best().items())],
        means={"/".join(map(str, k)): t
               for k, t in session.dataset().mean_times().items()})
    return res


def print_table(res: dict) -> None:
    where = res["device_name"] + (", payloads staged through the host"
                                  if res["device"].startswith("cuda") else "")
    print(f"measured {res['samples']} samples on {res['ranks']} ranks "
          f"({where}; {res['n_experiments']} experiments, penalty "
          f"{res['penalty'] * 100:.2f}%)")
    print(f"{'op':12s} {'bytes':>9s} {'winner':>22s} {'us':>9s}")
    for op, m, a, s, t in res["best"]:
        print(f"{op:12s} {m:9d} {a:>18s}/s{s} {t * 1e6:9.1f}")
    print(f"-> {res['out']} (backend={res['backend']})")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--sizes", nargs="+", type=int, default=list(SIZES),
                    help="message sizes in bytes")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default="device_measured_decision.json")
    ap.add_argument("--check", action="store_true",
                    help="hold every algorithm against the oracle first")
    ap.add_argument("--grad-elems", type=int, default=0,
                    help="all-reduce a gradient of this many fp32 "
                         "elements through the tuned choice and 'xla'")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run "
                               "the ranks on the host")
        from repro_torch.kernels import _build
        _build.build_all()      # once, before the ranks load it
    res = grp.spawn(_rank_main, args.ranks,
                    (tuple(args.sizes), args.trials, args.out, args.device,
                     args.check, args.grad_elems))
    print_table(res)
    return res


if __name__ == "__main__":
    main()
