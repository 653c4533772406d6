"""Training launcher of the port (``repro/launch/train.py``'s flags and
printed lines).

Spawns ``--ranks`` processes (default: the product of ``--topology``, else
one) that form one ``gloo`` group (`group.spawn`), each holding its
buffers on the card (``--device cuda``, the default; no GPU is an error)
or on the host (``--device cpu``, where the kernels take their plain
PyTorch versions). Every rank builds the launch mesh (``("data",
"model")``, or ``("pod", "data", "model")`` / ``("dcn", "pod", "data",
"model")`` under ``--topology``), the one `Communicator` of the launch
from ``--tuning-table`` / ``--collective`` / ``--bucket-mb``, and the
training step (`steps.build_train_step`), then takes ``--steps`` steps
over its rows of the synthetic global batches: forward and backward
(attention through the flash-attention kernels), the tuned gradient
sync (every reduce step in the ``segment_combine`` kernel) or the
backend's all-reduce (``--collective xla``, the default), and AdamW.
Rank 0 prints. Weights are random, drawn by a ``torch.Generator`` with
seed 0 on the device, the same in every rank.

Beyond the reference's lines the launcher prints each step's split into
forward+backward, gradient sync and optimizer seconds (the slowest
rank's), each rank's peak device memory, the kernel launches of the
steps summed over the ranks, and whether the replicas' params stayed
bit-identical after every step (a checksum gathered from every rank;
a difference raises).

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
Queue 1 step): ``--overlap-backward`` and ``--trace-dir`` (step 9),
``--model-parallel`` above 1 (step 8), FSDP (step 10), and every family
but dense (MoE step 8; SSM and hybrid step 9; VLM and enc-dec step 10).

Examples:
    python -m repro_torch.launch.train --arch smollm-135m --ranks 4 \\
        --topology 2x2 \\
        --tuning-table examples/artifacts/hierarchical_decision.json \\
        --steps 4 --seq 256 --batch 8
    python -m repro_torch.launch.train --arch smollm-135m --reduced \\
        --device cpu --ranks 2 --steps 2 --seq 64 --batch 4
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.checkpoint import save
from repro_torch.configs import ARCHITECTURES
from repro_torch.configs.base import (
    CollectiveConfig,
    ParallelConfig,
    ShapeConfig,
)
from repro_torch.core.collectives import group as grp
from repro_torch.data import SyntheticPipeline, batch_to_tensors, stream_ids
from repro_torch.kernels import attention, attention_bwd, segment_reduce
from repro_torch.launch.mesh import local_mesh_spec, make_local_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.models.registry import check_trainable

#: the kernels of the training path, by the name the launch counts use
COUNTERS = {"flash_attention": attention,
            "flash_attention_bwd": attention_bwd,
            "segment_combine": segment_reduce}

#: where each unported option comes from (ROADMAP.md Queue 1)
LATER = {
    "overlap_backward": "the backward-overlapped gradient sync "
                        "(--overlap-backward) comes with step 9",
    "trace_dir": "per-step telemetry (--trace-dir, obs/replay and "
                 "obs/residuals) comes with step 9",
    "model_parallel": "a model-parallel axis (--model-parallel > 1: expert "
                      "or tensor parallelism in the training step) comes "
                      "with step 8",
}


def _later(key: str):
    return NotImplementedError(f"{LATER[key]} (ROADMAP.md Queue 1)")


def _to_host(tree):
    return pytree.tree_map(lambda t: t.detach().cpu(), tree)


def _counts() -> dict:
    return {name: mod.launches for name, mod in COUNTERS.items()}


def _gather(obj) -> list:
    parts = [None] * grp.size()
    dist.all_gather_object(parts, obj)
    return parts


def _build_mesh(args, device, topology):
    """The launch mesh in every rank, through the placement sweep when
    ``--tune-mapping`` asks for it."""
    pods = dcn = 1
    if topology is not None:
        by_axis = {lv.axis: lv.size for lv in topology.levels}
        pods, dcn = by_axis.get("pod", 1), by_axis.get("dcn", 1)
    mapping = None
    if args.tune_mapping:
        from repro_torch.core.topology import Topology, tune_mesh_mapping
        shape, axes = local_mesh_spec(grp.size(), args.model_parallel,
                                      pods, dcn)
        sweep_topo = topology or Topology.single_level(
            shape[axes.index("data")])
        mapping = tune_mesh_mapping(sweep_topo, axes=axes, shape=shape,
                                    attach=False)
        if grp.rank() == 0:
            print(f"mesh mapping: {mapping.summary()}", flush=True)
    return make_local_mesh(args.model_parallel, pods, dcn, mapping=mapping,
                           device=device)


def _rank_main(opts: dict):
    """One rank's whole run; rank 0's return value is the result."""
    args = argparse.Namespace(**opts["args"])
    topology, cfg, shape = opts["topology"], opts["cfg"], opts["shape"]
    device = grp.device_of(args.device)
    lead = grp.rank() == 0

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    mesh = _build_mesh(args, device, topology)
    table_path = args.tuning_table or args.decision
    from repro_torch.comms import Communicator
    bucket_bytes = None if args.bucket_mb is None \
        else int(args.bucket_mb * (1 << 20))
    comm = Communicator.create(
        mesh, topology=topology, artifact=table_path,
        probe=args.probe_fabric, algorithm=args.collective,
        bucket_bytes=bucket_bytes)
    # an artifact stamped with a tuned mapping rebuilds the mesh at load:
    # everything downstream runs over THAT mesh
    mesh = comm.mesh
    if table_path:
        say(f"tuning table: {table_path} ({comm.describe()})")
    if comm.mapping is not None and not args.tune_mapping:
        say(f"mesh mapping (from artifact): {comm.mapping.summary()}")
    if comm.bucket_bytes:
        say(f"gradient sync: bucketed overlap pipeline "
            f"(bucket_bytes={comm.bucket_bytes})")
    elif args.probe_fabric:
        say(f"probed fabric: {comm.probed}")
    if args.probe_fabric and comm.probed_topology is not None:
        for lv in comm.probed_topology.levels:
            say(f"probed level {lv.name} (axis={lv.axis}, fan-out "
                f"{lv.size}): launch={lv.profile.launch:.2e}s "
                f"byte_time={lv.profile.byte_time:.2e}s/B")
    coll = CollectiveConfig(algorithm=args.collective, decision=table_path,
                            bucket_bytes=comm.bucket_bytes)
    parallel = opts["parallel"]
    step = build_train_step(cfg, shape, parallel, coll, mesh, lr=args.lr,
                            total_steps=args.steps, communicator=comm,
                            device=device)
    params = step.api.init(torch.Generator(device=device).manual_seed(0))
    opt_state = step.opt.init(params)
    pipe = SyntheticPipeline(cfg, shape, seed=0, streams=opts["streams"])

    coll_desc = f"table:{table_path}" if table_path else args.collective
    say(f"arch={cfg.name} devices={grp.size()} mesh={dict(mesh.shape)} "
        f"collective={coll_desc}")
    plan = comm.explain_gradients(params)
    if args.explain:
        say("gradient-sync plan (per leaf):" if not comm.bucket_bytes
            else "gradient-sync plan (bucketed pipeline):")
        say(plan.render())
    from repro_torch.launch.measure_collectives import plan_combines
    res = {"arch": cfg.name, "ranks": grp.size(), "device": str(device),
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
           "mesh": dict(mesh.shape), "describe": comm.describe(),
           "tuned": step.tuned, "rows": [step.rows.start, step.rows.stop],
           "leaves": len(pytree.leaves(params)),
           "param_elems": sum(t.numel() for t in pytree.leaves(params)),
           # collectives a step: the plan's, or one all-reduce a leaf
           "plan_entries": len(plan) if step.tuned
           else len(pytree.leaves(params)),
           "plan_combines": plan_combines(plan, grp.size())
           if step.tuned else 0,
           "losses": [], "step_s": [], "compute_s": [], "sync_s": [],
           "opt_s": [], "replicas_equal": []}
    replicas = _gather(pytree.fingerprint(params))
    res["replicas_equal_at_init"] = all(r == replicas[0] for r in replicas)
    keep = opts["keep_params"] and lead
    if keep:
        res["init_params"] = _to_host(params)

    for mod in COUNTERS.values():           # counts: the steps alone
        mod.launches = 0
    t_start = time.time()
    for i in range(args.steps):
        batch = batch_to_tensors(pipe.batch_at(i), device, rows=step.rows)
        t0 = time.time()
        params, opt_state, metrics = step.fn(params, opt_state, batch,
                                             keep_grads=keep and i == 0)
        loss = float(metrics["loss"])
        wall = time.time() - t0
        if "grads" in metrics:
            res["grads0"] = _to_host(metrics.pop("grads"))
            res["local_grads0_fingerprint"] = metrics.pop(
                "local_grads_fingerprint")
        split = grp.max_over_ranks([metrics["compute_s"], metrics["sync_s"],
                                    metrics["opt_s"]])
        replicas = _gather(pytree.fingerprint(params))
        equal = all(r == replicas[0] for r in replicas)
        for key, v in zip(("losses", "step_s", "compute_s", "sync_s",
                           "opt_s", "replicas_equal"),
                          (loss, wall, *split, equal)):
            res[key].append(v)
        if i % args.log_every == 0:
            say(f"step {i:4d} loss {loss:.4f} ({wall * 1e3:.0f} ms)")
            say(f"  forward+backward {split[0]:.3f} s, gradient sync "
                f"{split[1]:.3f} s, optimizer {split[2]:.3f} s (slowest "
                f"rank's)")
        if not equal:
            raise AssertionError(f"step {i}: the ranks' params differ "
                                 f"({len(replicas)} checksums)")
    done = time.time() - t_start
    res["launches"] = {k: sum(c[k] for c in _gather(_counts()))
                       for k in COUNTERS}
    res["peak_mem_bytes"] = _gather(
        torch.cuda.max_memory_allocated(device)
        if device.type == "cuda" else 0)
    say(f"done: {args.steps} steps in {done:.1f}s")
    say(f"replicas: params bit-identical over {grp.size()} ranks after "
        f"every step; launches over the steps, summed over the ranks: "
        + ", ".join(f"{k} {v}" for k, v in res["launches"].items()))
    if device.type == "cuda":
        say("peak device memory per rank: " + ", ".join(
            f"{b / 2**30:.2f} GiB" for b in res["peak_mem_bytes"]))
    if args.ckpt and lead:
        save(args.ckpt, {"params": params, "opt": opt_state},
             step=args.steps, extra={"arch": cfg.name})
        say(f"checkpoint -> {args.ckpt}")
    if keep:
        res["params"] = _to_host(params)
    return res if lead else None


def main(argv=None, *, keep_params: bool = False,
         parallel: ParallelConfig = None) -> dict:
    """Run the launch; returns rank 0's result (``keep_params``: with its
    initial and final params and step 0's synced gradients, on the host,
    as ``init_params``, ``params`` and ``grads0``, and the bit checksums
    of its step-0 gradients before the sync as
    ``local_grads0_fingerprint``). ``parallel`` replaces the default
    `ParallelConfig` (fp32 master weights, bf16 compute)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m",
                    choices=sorted(ARCHITECTURES))
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer smoke variant instead of the full config")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--collective", default="xla",
                    help="gradient-sync algorithm (xla/ring/rabenseifner/...)")
    ap.add_argument("--tuning-table", default=None,
                    help="path to a tuned DecisionTable artifact; routes "
                         "gradient sync through the tuned {algorithm, "
                         "segments} per message size")
    ap.add_argument("--decision", default=None,
                    help="deprecated alias for --tuning-table")
    ap.add_argument("--probe-fabric", action="store_true",
                    help="probe the live fabric before selecting a table "
                         "from a multi-backend artifact")
    ap.add_argument("--explain", action="store_true",
                    help="print the gradient-sync collective plan before "
                         "training")
    ap.add_argument("--bucket-mb", type=float, default=None,
                    help="fusion-bucket budget in MiB for the bucketed, "
                         "pipelined gradient sync (default: the "
                         "artifact's tuned schedule; 0 forces per leaf)")
    ap.add_argument("--overlap-backward", action="store_true",
                    help="backward-overlapped gradient sync (not ported: "
                         "raises)")
    ap.add_argument("--topology", default=None,
                    help="network hierarchy: a 'PODSxDATA' spec (2x2), a "
                         "3-tier 'DCNxPODSxDATA' spec (2x2x2), or a "
                         "Topology JSON path")
    ap.add_argument("--tune-mapping", action="store_true",
                    help="sweep rank placements against the topology and "
                         "build the mesh in the winning order")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--trace-dir", default=None,
                    help="per-step telemetry (not ported: raises)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes of the data-parallel group (default: "
                         "the topology's size, else 1)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.overlap_backward:
        raise _later("overlap_backward")
    if args.trace_dir:
        raise _later("trace_dir")
    if args.model_parallel > 1:
        raise _later("model_parallel")
    cfg = ARCHITECTURES[args.arch]
    check_trainable(cfg.family)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig(name="cli", seq_len=args.seq,
                        global_batch=args.batch, kind="train")
    topology = None
    if args.topology:
        from repro_torch.core.topology import SYNC_AXES, Topology
        if os.path.exists(args.topology):
            topology = Topology.load(args.topology)
        else:
            topology = Topology.from_spec(args.topology)
        # probe-derived topologies carry no mesh axes: assign the sync
        # axes positionally (innermost -> "data", then "pod", then "dcn")
        if all(lv.axis is None for lv in topology.levels):
            topology = type(topology)(tuple(
                dataclasses.replace(lv, axis=ax)
                for lv, ax in zip(topology.levels, SYNC_AXES)))
    ranks = args.ranks or (topology.total_size * args.model_parallel
                           if topology else 1)
    if topology is not None:
        by_axis = {lv.axis: lv.size for lv in topology.levels}
        pods, dcn = by_axis.get("pod", 1), by_axis.get("dcn", 1)
        mesh_shape, mesh_axes = local_mesh_spec(ranks, args.model_parallel,
                                                pods, dcn)
        data_spec = by_axis.get("data")
        if data_spec is not None and \
                mesh_shape[mesh_axes.index("data")] != data_spec:
            raise SystemExit(
                f"--topology names {data_spec} data ranks per group but "
                f"the ranks yield {mesh_shape[mesh_axes.index('data')]} "
                f"({ranks} ranks / {dcn} dcn / {pods} pods / "
                f"{args.model_parallel} model-parallel); a table tuned at "
                f"fan-out {data_spec} would silently mis-decide")
        desc = " > ".join(f"{lv.name}({lv.size})"
                          for lv in reversed(topology.levels))
        print(f"topology: {desc}", flush=True)
    parallel = parallel or ParallelConfig()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to train "
                               "on the host")
        from repro_torch.kernels import _build
        _build.build_all()      # once, before the ranks load it
    opts = dict(args=vars(args), cfg=cfg, shape=shape, topology=topology,
                parallel=parallel, streams=stream_ids(cfg, shape),
                keep_params=keep_params)
    return grp.spawn(_rank_main, ranks, (opts,))


if __name__ == "__main__":
    main()
