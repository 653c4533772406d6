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
(attention through the flash-attention kernels, the SSM and hybrid
families' SSD scan through the SSD chunk forward and backward kernels),
the tuned gradient
sync (every reduce step in the ``segment_combine`` kernel) or the
backend's all-reduce (``--collective xla``, the default), and AdamW.
Rank 0 prints. Weights are random, drawn by a ``torch.Generator`` with
seed 0 on the device, the same in every rank.

Beyond the reference's lines the launcher prints each step's split into
forward+backward, gradient sync and optimizer seconds (the slowest
rank's), each rank's peak device memory, the kernel launches of the
steps summed over the ranks, and whether the replicas' params stayed
bit-identical after every step (a checksum gathered from every rank;
a difference raises). The result also keeps, for each rank, its params
(``param_elems_by_rank``), the collectives of its step 0 by kind and
axis (``step_collectives``, a ``group.Record``) and each step's peak
device memory with its arguments live (``step_peak_bytes``): what the
dry-run's trace of the same step predicts (``launch/dryrun.py``).

``--overlap-backward`` (tuned sync only) syncs each layer's gradients
on a thread of every rank while autograd computes the layers below
(`steps.build_train_step`); the printed split then reads the exposed
sync, the wait after the backward. ``--trace-dir DIR`` replays every
step's gradient-sync schedule task by task in every rank
(`obs.replay.measure_gradient_schedule`, outside the timed step) and
writes rank 0's ``step{NNN}.trace.json`` (Perfetto) and
``step{NNN}.summary.json`` into DIR, and, with a ``--topology``, prints
the drift line the re-tune loop watches, as the reference does.

Every family trains: dense, VLM (llava-next-mistral-7b: patch
embeddings in front of the text, labels -1 over them), MoE (olmoe), SSM
(mamba2), hybrid (zamba2) and enc-dec (whisper-large-v3: audio frames
into the encoder). ``--model-parallel`` above 1 adds a ``model`` axis
to the mesh (``--ranks`` defaults to the topology's size, else 1, times
it). The MoE family splits its experts over it (expert parallelism,
`steps.build_train_step`): each rank holds its slice of every layer's
experts and the dispatch all-to-all runs as the Communicator (or
``"xla"``) resolves it. Every other family trains tensor-parallel, as
the reference's ``param_specs`` lays it out: each rank holds its slice
of the heads, FFN columns and vocab wherever the axis divides them
(smollm-135m's 9 heads do not divide 2, so its attention runs whole on
every rank), and the blocks all-reduce over ``model``. The gradient
sync runs over the data axes. The replica check reads the replicated
params on every rank and each slice on the data ranks that hold it;
``--ckpt`` gathers the slices over ``model`` first, so rank 0 writes
whole leaves.

FSDP has no flag, as in the reference: ``main(argv,
parallel=ParallelConfig(shard_params_over_data=True))`` (the untuned
sync only). Each rank holds its shard of every weight the data axes
split (`sharding.fsdp_shard`); with ``--model-parallel`` above 1, of its
tensor-parallel slice or experts (`sharding.shard`: both halves of the
reference's ``param_specs``, the data axes then those of each model
coordinate). The start line names the layout; the launcher prints the
data axes, the params a rank and the leaves sharded over data, split
over ``model``, both and neither, and, each step, the gathers,
reduce-scatters and all-reduces it issued with the seconds in the
gathers, the reduce-scatters and the model-axis collectives. The
replica check reads each leaf on the ranks that hold the same part of
it (a leaf cut by both halves has no replica); ``--ckpt`` and
``keep_params`` gather both halves first (`sharding.gather`), so they
hold whole leaves in the reference's format.

Examples:
    python -m repro_torch.launch.train --arch smollm-135m --ranks 4 \\
        --topology 2x2 \\
        --tuning-table examples/artifacts/hierarchical_decision.json \\
        --steps 4 --seq 256 --batch 8
    python -m repro_torch.launch.train --arch smollm-135m --ranks 4 \\
        --topology 2x2 \\
        --tuning-table examples/artifacts/hierarchical_decision.json \\
        --steps 4 --seq 256 --batch 8 --overlap-backward --trace-dir /tmp/t
    python -m repro_torch.launch.train --arch mamba2-130m --ranks 4 \\
        --topology 2x2 \\
        --tuning-table examples/artifacts/hierarchical_decision.json \\
        --steps 4 --seq 256 --batch 8
    python -m repro_torch.launch.train --arch olmoe-1b-7b --ranks 4 \\
        --model-parallel 2 \\
        --tuning-table examples/artifacts/tuned_decision.json \\
        --steps 3 --seq 256 --batch 8
    python -m repro_torch.launch.train --arch smollm-135m --ranks 4 \\
        --model-parallel 2 \\
        --tuning-table examples/artifacts/tuned_decision.json \\
        --steps 2 --seq 256 --batch 8
    python -m repro_torch.launch.train --arch smollm-135m --reduced \\
        --device cpu --ranks 4 --model-parallel 2 --collective ring \\
        --steps 2 --seq 64 --batch 8
    python -m repro_torch.launch.train --arch smollm-135m --reduced \\
        --device cpu --ranks 2 --steps 2 --seq 64 --batch 4
    python -m repro_torch.launch.train --arch whisper-large-v3 --reduced \\
        --device cpu --ranks 2 --steps 2 --seq 64 --batch 4
    python -m repro_torch.launch.train --arch llava-next-mistral-7b \\
        --reduced --device cpu --ranks 2 --steps 2 --seq 64 --batch 4
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
    CollectiveConfigError,
    ParallelConfig,
    ShapeConfig,
    validate_collectives,
)
from repro_torch.core.collectives import group as grp
from repro_torch.data import SyntheticPipeline, batch_to_tensors, stream_ids
from repro_torch.kernels.ops import TRAIN_COUNTERS as COUNTERS
from repro_torch.launch.mesh import local_mesh_spec, make_local_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.parallel import sharding as sh

def _to_host(tree):
    """A host copy (the steps update the params in place)."""
    return pytree.tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _counts() -> dict:
    return {name: mod.launches for name, mod in COUNTERS.items()}


def _gather(obj) -> list:
    parts = [None] * grp.size()
    dist.all_gather_object(parts, obj)
    return parts


def _write_step_trace(args, comm, params, runner, topology, step,
                      wall_ms):
    """One step's telemetry artifacts: replay-measure the gradient-sync
    schedule in every rank (per-task wall times, the slowest rank's, off
    the critical path), join it against the analytical prediction, and
    have rank 0 write the Perfetto trace and the flat summary and print
    the drift line the re-tune loop watches."""
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import replay as obs_replay
    from repro_torch.obs import residuals as obs_residuals

    spans = obs_replay.measure_gradient_schedule(
        comm, params, overlap_backward=args.overlap_backward,
        runner=runner)
    if grp.rank() != 0:
        return
    names = [lv.name for lv in topology.levels] if topology else None
    obs_export.write_chrome_trace(
        os.path.join(args.trace_dir, f"step{step:03d}.trace.json"),
        spans, level_names=names)
    resid = None
    if topology is not None:
        try:
            resid = obs_residuals.gradient_residual_report(
                comm, params, spans=spans, topology=topology,
                overlap_backward=args.overlap_backward)
        except ValueError as e:
            print(f"trace: residuals skipped ({e})", flush=True)
    obs_export.write_summary(
        os.path.join(args.trace_dir, f"step{step:03d}.summary.json"),
        counters=comm.metrics, residuals=resid,
        extra={"step": step, "wall_ms": wall_ms,
               "n_tasks": len(spans)})
    if resid is not None:
        print(f"trace: step {step:4d} drift {resid.drift():.3f} "
              f"(measured {resid.measured_tasks()}/{len(resid.tasks)} "
              f"tasks, exposed comm "
              f"{resid.modeled_exposed * 1e6:.0f} us modeled)", flush=True)


def _replicas(params, step) -> bool:
    """Whether the ranks hold equal params: each leaf on the ranks that
    hold the same part of it (`TrainStep.kinds`): a whole leaf on every
    rank, a model slice (experts, tensor-parallel) on the data ranks of
    its model coordinate, an FSDP shard on the model ranks of its data
    index; a leaf cut by both halves has no replica. One bit checksum a
    kind a rank, gathered."""
    mesh = step.mesh
    alone = {("model", "data")}         # kinds with no replica
    if sh.model_size(mesh) == 1:
        alone.add(("data",))
    if sh.dp_size(mesh) == 1:
        alone.add(("model",))
    mine = {k: pytree.fingerprint(t) for k, t in step.kinds(params).items()
            if k not in alone}
    coords = {("model",): grp.rank(mesh.axis(step.model_axis))
              if step.model_axis else 0,
              ("data",): sh.dp_index(mesh) if step.fsdp else 0}
    fps = _gather((mine, coords))
    return all(g[0][k] == fp for f in fps for k, fp in f[0].items()
               for g in fps if k == () or g[1][k] == f[1][k])


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
                            bucket_bytes=comm.bucket_bytes,
                            overlap_backward=args.overlap_backward)
    parallel = opts["parallel"]
    step = build_train_step(cfg, shape, parallel, coll, mesh, lr=args.lr,
                            total_steps=args.steps, communicator=comm,
                            device=device)
    if args.overlap_backward and step.model_axis is None:
        say("gradient sync: backward-overlapped release streams")
    elif args.overlap_backward:
        kind = "expert" if step.ep_axis else "tensor"
        say(f"gradient sync: backward-overlapped release streams over the "
            f"data tiers, on the sync thread, while the backward's "
            f"collectives over {step.model_axis} ({kind} parallelism) run "
            f"on the main thread")
    params = step.init(torch.Generator(device=device).manual_seed(0))
    opt_state = step.opt.init(params)
    pipe = SyntheticPipeline(cfg, shape, seed=0, streams=opts["streams"])

    coll_desc = f"table:{table_path}" if table_path else args.collective
    layout = "+".join(n for n, on in (("fsdp", step.fsdp),
                                      ("tp", step.tp_axis),
                                      ("ep", step.ep_axis)) if on) \
        or "replicated"
    say(f"arch={cfg.name} devices={grp.size()} mesh={dict(mesh.shape)} "
        f"collective={coll_desc} layout={layout}")
    # under FSDP the step's collectives are its gathers, reduce-scatters
    # and all-reduces, printed with each step, not a sync plan
    plan = None if step.fsdp else comm.explain_gradients(
        params, overlap_backward=args.overlap_backward)
    if args.explain and plan is not None:
        say("gradient-sync plan (backward-overlapped streams):"
            if args.overlap_backward else
            "gradient-sync plan (per leaf):" if not comm.bucket_bytes
            else "gradient-sync plan (bucketed pipeline):")
        say(plan.render())
    runner = None
    if args.trace_dir:
        from repro_torch.obs import replay as obs_replay
        if lead:
            os.makedirs(args.trace_dir, exist_ok=True)
        # one runner for the whole run: its operands are made once
        runner = obs_replay.ScheduleRunner(mesh)
        trace_topo = topology or comm.probed_topology
        if trace_topo is None:
            say("trace: no --topology attached, writing traces without "
                "modeled residuals")
    from repro_torch.launch.measure_collectives import plan_combines
    res = {"arch": cfg.name, "ranks": grp.size(), "device": str(device),
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
           "mesh": dict(mesh.shape), "describe": comm.describe(),
           "layout": layout,
           "tuned": step.tuned, "rows": [step.rows.start, step.rows.stop],
           "leaves": len(pytree.leaves(params)),
           "param_elems": sum(t.numel() for t in pytree.leaves(params)),
           "param_elems_by_rank": _gather(
               sum(t.numel() for t in pytree.leaves(params))),
           # collectives a step: the plan's, or one all-reduce a leaf
           # (under FSDP: step 0's gathers, reduce-scatters, all-reduces)
           "plan_entries": len(plan) if step.tuned
           else len(pytree.leaves(params)),
           "plan_combines": plan_combines(plan, grp.size())
           if step.tuned else 0,
           "losses": [], "step_s": [], "compute_s": [], "sync_s": [],
           "opt_s": [], "replicas_equal": [], "release_sync_s": [],
           "release_events": [], "gather_s": [], "reduce_scatter_s": [],
           "model_s": []}
    if step.ep_axis is not None:
        tp = mesh.shape[step.ep_axis]
        lo, hi = sh.expert_range(mesh, cfg.num_experts, step.ep_axis)
        # one layer's dispatch buffer (E, C, d) in the compute dtype,
        # C from this rank's rows x its S/tp sequence chunk
        tokens = (step.rows.stop - step.rows.start) * shape.seq_len // tp
        res["dispatch_bytes"] = cfg.num_experts * cfg.d_model * \
            moe.capacity(cfg, tokens) * \
            pytree.itemsize(opts["parallel"].compute_dtype)
        res["a2a_algorithm"] = comm.a2a_algorithm_for(
            res["dispatch_bytes"], step.ep_axis, tp)
        res["experts"] = _gather([lo, hi])
        # one layer's expert stack as this rank holds it (E/tp, d, ff),
        # or (E/tp, d/dp, ff) under FSDP
        res["expert_shape"] = list(params["layers"][0]["moe"]["w_gate"].shape)
        say(f"expert parallelism: {cfg.num_experts} experts over "
            f"{step.ep_axis}={tp}, {hi - lo} a rank; dispatch all-to-all "
            f"of {res['dispatch_bytes']} B each way a layer: "
            f"{res['a2a_algorithm']}")
    if step.tp_axis is not None:
        tp = mesh.shape[step.tp_axis]
        counts = {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
                  "ffn": cfg.d_ff, "vocab": L.pad_vocab(cfg.vocab_size)}
        res["tp_split"] = {n: c % tp == 0 for n, c in counts.items()}
        say(f"tensor parallelism over {step.tp_axis}={tp}: "
            + ", ".join(f"{n} {c} "
                        + ("split" if res["tp_split"][n] else "whole")
                        for n, c in counts.items())
            + f"; {res['param_elems']} params a rank")
    if step.fsdp:
        n = {k: len(pytree.leaves(t))
             for k, t in step.kinds(params).items()}
        leaves = {name: n.get(k, 0) for name, k in (
            ("data", ("data",)), ("model", ("model",)),
            ("both", ("model", "data")), ("neither", ()))}
        res["fsdp"] = {"data_axes": list(sh.dp_axes(mesh)),
                       "sharded_leaves": leaves["data"] + leaves["both"],
                       "replicated_leaves": leaves["model"]
                       + leaves["neither"]}
        what = ""
        if step.model_axis:
            res["fsdp"].update(model_axis=step.model_axis, leaves=leaves)
            kind = "expert" if step.ep_axis else "tensor"
            what = (f" of each model coordinate, {kind} parallelism over "
                    f"{step.model_axis}={mesh.shape[step.model_axis]}")
        say(f"FSDP over the data axes {tuple(sh.dp_axes(mesh))} "
            f"({sh.dp_size(mesh)} ranks){what}: {res['param_elems']} "
            f"params a rank; leaves: {leaves['data']} sharded over data, "
            f"{leaves['model']} split over model, {leaves['both']} both, "
            f"{leaves['neither']} neither")
    res["replicas_equal_at_init"] = _replicas(params, step)
    keep = opts["keep_params"] and lead

    def kept(tree):
        """``tree`` on the host, whole (FSDP shards gathered on every
        rank: collective)."""
        whole = step.gather(tree) if step.fsdp else tree
        return _to_host(whole) if keep else None
    if opts["keep_params"]:
        res["init_params"] = kept(params)

    for mod in COUNTERS.values():           # counts: the steps alone
        mod.launches = 0
    replay = {name: 0 for name in COUNTERS}
    run_peak, step_peaks = 0, []
    t_start = time.time()
    for i in range(args.steps):
        batch = batch_to_tensors(pipe.batch_at(i), device, rows=step.rows)
        if device.type == "cuda":        # the step's own peak, args live
            run_peak = max(run_peak, torch.cuda.max_memory_allocated(device))
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        with grp.Record() as record:
            params, opt_state, metrics = step.fn(
                params, opt_state, batch,
                keep_grads=opts["keep_params"] and i == 0)
        if device.type == "cuda":
            step_peaks.append(torch.cuda.max_memory_allocated(device))
        if i == 0:      # every rank's, by kind and axis
            res["step_collectives"] = _gather(record.by_kind())
        loss = float(metrics["loss"])
        wall = time.time() - t0
        if "grads" in metrics:
            grads = metrics.pop("grads")
            # tensor-parallel: every rank gathers the whole tree (rank 0
            # keeps it), to hold the slices' gradients against a run
            # without a model axis; FSDP keeps whole leaves only
            whole = None
            if step.fsdp:
                grads = step.gather(grads)
            elif step.tp_axis:
                whole = step.gather(grads)
            if keep:
                res["grads0"] = _to_host(grads)
                res["local_grads0_fingerprint"] = metrics.pop(
                    "local_grads_fingerprint")
                if whole is not None:
                    res["grads0_whole"] = _to_host(whole)
            del grads, whole
        split = grp.max_over_ranks([metrics["compute_s"], metrics["sync_s"],
                                    metrics["opt_s"],
                                    metrics.get("release_sync_s", 0.0),
                                    metrics.get("gather_s", 0.0),
                                    metrics.get("reduce_scatter_s", 0.0),
                                    metrics.get("model_s", 0.0)])
        equal = _replicas(params, step)
        for key, v in zip(("losses", "step_s", "compute_s", "sync_s",
                           "opt_s", "release_sync_s", "gather_s",
                           "reduce_scatter_s", "model_s", "replicas_equal"),
                          (loss, wall, *split, equal)):
            res[key].append(v)
        if step.fsdp and i == 0:
            res["collectives"] = metrics["collectives"]
            res["plan_entries"] = sum(metrics["collectives"].values())
        if args.overlap_backward:      # every rank's, in release order
            res["release_events"].append(_gather(metrics["release_events"]))
        if i % args.log_every == 0:
            say(f"step {i:4d} loss {loss:.4f} ({wall * 1e3:.0f} ms)")
            say(f"  forward+backward {split[0]:.3f} s, gradient sync "
                f"{split[1]:.3f} s"
                + (f" exposed ({split[3]:.3f} s on the sync thread)"
                   if args.overlap_backward else "")
                + f", optimizer {split[2]:.3f} s (slowest rank's)")
            if step.fsdp:
                c = metrics["collectives"]
                say(f"  FSDP collectives: {c['gathers']} gathers "
                    f"({split[4]:.3f} s), {c['reduce_scatters']} "
                    f"reduce-scatters ({split[5]:.3f} s), "
                    f"{c['all_reduces']} all-reduces over the data axes"
                    + (f"; over {step.model_axis}: "
                       f"{c['model_all_reduces']} all-reduces, "
                       f"{c['model_all_gathers']} all-gathers, "
                       f"{c['model_all_to_alls']} all-to-alls "
                       f"({split[6]:.3f} s)" if step.model_axis else "")
                    + " (slowest rank's)")
        if not equal:
            raise AssertionError(f"step {i}: the ranks' params differ "
                                 f"({grp.size()} checksums)")
        if runner is not None:
            # the replay's launches are not the step's: counted apart
            before = _counts()
            _write_step_trace(args, comm, params, runner, trace_topo, i,
                              wall_ms=wall * 1e3)
            for name, mod in COUNTERS.items():
                replay[name] += mod.launches - before[name]
                mod.launches = before[name]
    done = time.time() - t_start
    res["launches"] = {k: sum(c[k] for c in _gather(_counts()))
                       for k in COUNTERS}
    res["replay_launches"] = {k: sum(c[k] for c in _gather(replay))
                              for k in COUNTERS}
    res["peak_mem_bytes"] = _gather(
        max(run_peak, torch.cuda.max_memory_allocated(device))
        if device.type == "cuda" else 0)
    res["step_peak_bytes"] = _gather(step_peaks)
    say(f"done: {args.steps} steps in {done:.1f}s")
    if step.fsdp and step.model_axis:
        held = (f"each leaf bit-identical over the ranks that hold the same "
                f"part of it (whole: all {grp.size()}; a model slice: its "
                f"{sh.dp_size(mesh)} data ranks; an FSDP shard: its "
                f"{sh.model_size(mesh)} model ranks; a leaf cut by both has "
                f"no replica)")
    elif step.fsdp:
        held = (f"replicated params bit-identical over {grp.size()} ranks "
                f"(an FSDP shard has no replica)")
    elif step.model_axis is None:
        held = f"params bit-identical over {grp.size()} ranks"
    else:
        held = (f"replicated params bit-identical over {grp.size()} ranks, "
                f"each {'expert' if step.ep_axis else 'tensor-parallel'} "
                f"slice over the {sh.dp_size(mesh)} data ranks that hold "
                f"it,")
    say(f"replicas: {held} after every step; launches over the steps, "
        f"summed over the ranks: "
        + ", ".join(f"{k} {v}" for k, v in res["launches"].items()))
    if device.type == "cuda":
        say("peak device memory per rank: " + ", ".join(
            f"{b / 2**30:.2f} GiB" for b in res["peak_mem_bytes"]))
    if args.ckpt:
        # whole leaves (every expert, slice or shard), on every rank
        tree = step.gather({"params": params, "opt": opt_state})
        if lead:
            save(args.ckpt, tree, step=args.steps, extra={"arch": cfg.name})
        say(f"checkpoint -> {args.ckpt}")
    if opts["keep_params"]:
        res["params"] = kept(params)
    return res if lead else None


def main(argv=None, *, keep_params: bool = False,
         parallel: ParallelConfig = None, config: dict = None) -> dict:
    """Run the launch; returns rank 0's result (``keep_params``: with its
    initial and final params and step 0's synced gradients, on the host,
    as ``init_params``, ``params`` and ``grads0``, and the bit checksums
    of its step-0 gradients before the sync as
    ``local_grads0_fingerprint``). ``parallel`` replaces the default
    `ParallelConfig` (fp32 master weights, bf16 compute); ``config``
    replaces fields of the model's config (``{"num_layers": 2}``: a
    full-width model cut in depth to fit one card)."""
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
                    help="sync each layer's gradients while the backward "
                         "computes the layers below (tuned sync only)")
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
                    help="write each step's replayed gradient-sync trace "
                         "(Perfetto JSON) and summary here")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes of the data-parallel group (default: "
                         "the topology's size, else 1)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = ARCHITECTURES[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    if config:
        cfg = cfg.replace(**config)
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
    ranks = args.ranks or ((topology.total_size if topology else 1)
                           * args.model_parallel)
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
        model_lv = next((lv for lv in topology.levels
                         if lv.axis == "model"), None)
        if model_lv is not None and model_lv.size != args.model_parallel:
            raise SystemExit(
                f"--topology names {model_lv.size} model-parallel ranks "
                f"({model_lv.name}) but --model-parallel is "
                f"{args.model_parallel}")
        desc = " > ".join(f"{lv.name}({lv.size})"
                          for lv in reversed(topology.levels))
        print(f"topology: {desc}", flush=True)
    parallel = parallel or ParallelConfig()
    try:        # tuned, as the Communicator will be: the flags alone say
        validate_collectives(CollectiveConfig(
            algorithm=args.collective,
            decision=args.tuning_table or args.decision,
            bucket_bytes=int((args.bucket_mb or 0) * (1 << 20)),
            overlap_backward=args.overlap_backward), parallel)
    except CollectiveConfigError as e:
        raise SystemExit(f"invalid flags: {e}")
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
