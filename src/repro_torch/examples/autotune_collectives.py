"""The paper end-to-end through the unified autotuning pipeline (port of
``examples/autotune_collectives.py``, over the port's ``core.tuning``,
``core.collectives.synth``, ``core.topology`` and ``comms``):

  1. pareto fronts of step programs synthesized for every grid fan-out;
  2. a TuningSession runs every tuner family of the survey over the same
     simulator grid, deduplicating measurements in the shared cache;
  3. each tuner is scored on the survey's two axes, measurement budget
     and mean penalty; the best DecisionTable is saved as
     ``tuned_decision.json``, its measurements as
     ``tuned_measurements.json``;
  4. warm start (a re-fit from the saved cache costs no experiment) and
     drift-aware re-tuning;
  5. per-level tuning of a 2-pod and of the 3-tier 2x2x2 topology into
     ``hierarchical_decision.json`` and
     ``hierarchical_decision_3level.json`` (with its bucket schedule);
  6. the Communicator built from each artifact, and its ``explain``.

The simulator touches no device. The artifacts are byte for byte the
reference's (``examples/artifacts/``) and load in either package.

Run:  PYTHONPATH=src python -m repro_torch.examples.autotune_collectives \\
          --out DIR
"""
from __future__ import annotations

import argparse
import os

from repro_torch.comms import CollectiveRequest, Communicator
from repro_torch.core.collectives import synth
from repro_torch.core.collectives.schedule import coalesce_bytes
from repro_torch.core.topology import (
    Topology,
    decided_hierarchical_methods,
    flat_time,
    hierarchical_allreduce_time,
    pipelined_sync_time,
    sequential_sync_time,
    tune_topology,
)
from repro_torch.core.tuning import (
    DECODE_MESSAGE_SIZES,
    Method,
    NetworkProfile,
    NetworkSimulator,
    SimulatorBackend,
    TuningSession,
    drifted,
    make_tuner,
)

OPS = ("all_reduce", "all_gather", "all_to_all")
PS = (4, 16, 64, 256)
# the coarse training-regime sweep (4 KB..4 MB x4) densified with the
# KB-scale decode regime, so the artifact serves both the gradient-sync
# launchers and the per-token serving collectives
MS = tuple(sorted(set(1024 * 4 ** i for i in range(7))
                  | set(DECODE_MESSAGE_SIZES)))

TUNER_NAMES = ("exhaustive", "thinned", "smgd", "regression", "ann",
               "ensemble", "decision_tree", "quadtree", "octree", "star",
               "feedback")
ARTIFACTS = ("tuned_decision.json", "hierarchical_decision.json",
             "hierarchical_decision_3level.json")


def run(out: str = ".") -> dict:
    """The whole pipeline; writes the four artifacts into ``out`` and
    returns their paths."""
    os.makedirs(out, exist_ok=True)
    path = {name: os.path.join(out, name) for name in
            ARTIFACTS + ("tuned_measurements.json",)}
    sim = NetworkSimulator(NetworkProfile(seed=0))
    session = TuningSession(SimulatorBackend(sim), trials=3)

    # fronts registered BEFORE tuning, so every tuner ranks `synth:`
    # schedules against the hand-written menu on equal footing
    fronts = synth.synthesize_all(OPS, (2,) + PS)
    print("== synthesized schedule fronts (op, p -> programs) ==")
    for (op, p), names in sorted(fronts.items()):
        if names:
            print(f"  {op:14s} p={p:<4d} {', '.join(names)}")

    print("\n== fit all tuner families over one shared measurement cache ==")
    reports = session.fit_all([make_tuner(n, OPS, PS, MS)
                               for n in TUNER_NAMES])
    print(f"{'tuner':14s} {'new exps':>9s} {'cache hits':>11s} "
          f"{'penalty':>8s}")
    for r in reports:
        print(f"{r.name:14s} {r.n_experiments:9d} {r.cache_hits:11d} "
              f"{r.penalty * 100:7.2f}%")
    best = TuningSession.best(reports)
    best.table.save(path["tuned_decision.json"])
    print(f"\nbest tuner: {best.name} ({best.n_experiments} experiments, "
          f"{best.penalty * 100:.2f}% penalty)")
    print(f"decision table -> {path['tuned_decision.json']} (use: python "
          f"-m repro_torch.launch.train --tuning-table "
          f"{path['tuned_decision.json']})")

    # warm start: a new session from the saved cache re-fits for free
    session.save_measurements(path["tuned_measurements.json"])
    warm = TuningSession(SimulatorBackend(sim), trials=3)
    warm.load_measurements(path["tuned_measurements.json"])
    warm.fit_all([make_tuner("regression", OPS, PS, MS)])
    print(f"\nwarm start: regression re-fit cost {warm.n_experiments} new "
          f"experiments ({warm.cache_hits} cache hits)")

    # drift: bandwidth collapses 3x -> sentinel probes detect it, the
    # cache is dropped, and the next fit re-measures the changed fabric
    warm.backend = SimulatorBackend(
        NetworkSimulator(drifted(sim.profile, byte_time_mult=3.0)))
    retuned = warm.retune_if_drifted(threshold=0.2)
    rep = warm.fit_all([make_tuner("exhaustive", OPS, PS, MS)])[0]
    print(f"drift detected={retuned}; re-tune ran {rep.n_experiments} new "
          f"experiments, penalty {rep.penalty * 100:.2f}% on the drifted "
          f"fabric")

    print("\n== per-level tuning on a 2-pod topology (4 ranks / pod) ==")
    topo = Topology.two_level(4, 2)
    hier, level_reports = tune_topology(topo, ms=MS)
    for name, reps in level_reports.items():
        b = TuningSession.best(reps)
        print(f"  {name:10s} tuner={b.name:12s} "
              f"experiments={b.n_experiments}")
    m = 4 << 20
    t_hier = hierarchical_allreduce_time(
        topo, decided_hierarchical_methods(hier, topo, m), m)
    t_xla = flat_time(topo, "all_reduce", Method("xla", 1), m)
    print(f"  {m >> 20} MB all-reduce: hierarchical {t_hier * 1e6:.0f} us "
          f"vs flat XLA {t_xla * 1e6:.0f} us ({t_xla / t_hier:.1f}x)")
    hier.save(path["hierarchical_decision.json"])
    print(f"hierarchical artifact -> {path['hierarchical_decision.json']} "
          f"(schema 3; use: python -m repro_torch.launch.train --topology "
          f"2x4 --tuning-table {path['hierarchical_decision.json']})")

    # the full host/pod/DCN stack: one table per tier in one schema-3
    # artifact, consumed by the 3-level gradient sync
    print("\n== per-level tuning on the 3-tier 2x2x2 "
          "(DCN x pods x hosts) topology ==")
    topo3 = Topology.from_spec("2x2x2")
    # a transformer-ish gradient-leaf mix: tuning it stamps the bucketed
    # overlap schedule (bucket_bytes) into the artifact
    leaf_mix = [4 << 20, 64 << 10, 64 << 10, 16 << 10] * 6
    hier3, level_reports3 = tune_topology(topo3, ms=MS,
                                          schedule_leaf_bytes=leaf_mix)
    for name, reps in level_reports3.items():
        b = TuningSession.best(reps)
        print(f"  {name:10s} tuner={b.name:12s} "
              f"experiments={b.n_experiments}")
    t_hier3 = hierarchical_allreduce_time(
        topo3, decided_hierarchical_methods(hier3, topo3, m), m)
    t_xla3 = flat_time(topo3, "all_reduce", Method("xla", 1), m)
    print(f"  {m >> 20} MB all-reduce: 3-level hierarchical "
          f"{t_hier3 * 1e6:.0f} us vs flat XLA {t_xla3 * 1e6:.0f} us "
          f"({t_xla3 / t_hier3:.1f}x)")
    sched = hier3.levels[0][1].meta.schedule
    buckets = coalesce_bytes(leaf_mix, sched["bucket_bytes"])
    t_seq = sequential_sync_time(topo3, hier3, leaf_mix)
    t_pipe = pipelined_sync_time(topo3, hier3, buckets)
    print(f"  gradient sync ({len(leaf_mix)} leaves): per-leaf "
          f"{t_seq * 1e6:.0f} us vs bucketed+pipelined "
          f"{t_pipe * 1e6:.0f} us ({t_seq / t_pipe:.2f}x, "
          f"bucket_bytes={sched['bucket_bytes']})")
    hier3.save(path["hierarchical_decision_3level.json"])
    print(f"3-level artifact -> {path['hierarchical_decision_3level.json']}"
          f" (carries the tuned bucket schedule; use: python -m "
          f"repro_torch.launch.train --topology 2x2x2 --tuning-table "
          f"{path['hierarchical_decision_3level.json']} --explain)")

    print("\n== Communicator: the single tuned-dispatch entry point ==")
    for art in ARTIFACTS:
        comm = Communicator.create(artifact=path[art])
        print(f"{art}: {comm.describe()}")
        # explain() renders the {algorithm, segments, level} the
        # launchers will execute for these messages
        print(comm.explain([
            CollectiveRequest("all_reduce", 4 << 20, axis="data",
                              axis_size=4, dtype="float32"),
            CollectiveRequest("all_gather", 64 << 10, axis="data",
                              axis_size=4, dtype="bfloat16"),
        ]).render())
    print("(launchers build the same object: --tuning-table selects the "
          "artifact, --probe-fabric probes the live fabric first)")
    return path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=".",
                    help="directory of the artifacts (default: here)")
    args = ap.parse_args(argv)
    return run(args.out)


if __name__ == "__main__":
    main()
