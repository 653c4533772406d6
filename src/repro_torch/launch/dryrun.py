"""Compile-free dry-run: trace one rank's step of every (architecture x
input shape) on the production mesh with ``meta`` stand-ins (no
allocation), then record its memory, FLOPs, bytes and collectives (port
of ``repro/launch/dryrun.py``).

Usage:
    python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k --multipod
    python -m repro_torch.launch.dryrun --all          # every combo, single-pod

The reference lowers and compiles the step over 512 host devices and
reads XLA's analyses. The port runs the step of the rank at coordinate 0
of a recording mesh (``group.MetaMesh``, 16 x 16 or 2 x 16 x 16) on
``meta`` tensors under ``accounting.StepCounter``: every operation of
the forward, the backward, the recompute under ``remat="full"`` and the
optimizer is seen, so the count is exact at full depth. XLA counts a
loop body once, and the reference corrects its count by lowering 1 and 2
layer units and extrapolating; the port has no loop to correct for, so
`accounting_metrics` traces 1 and 2 units AND full depth and checks that
``f(1) + (U - 1) * (f(2) - f(1))`` equals the full-depth FLOPs, bytes and
collective bytes exactly: the per-layer program is uniform. A failed
check or step raises; ``--all`` reports each failure and exits non-zero.

The record keeps the reference's fields, renamed where they name the
TPU: ``fits_hbm`` (of an 80 GB H100) for ``fits_16gb_hbm``, ``trace_s``
for ``lower_s`` / ``compile_s``, and a ``hardware`` block naming the
roofline's constants (``accounting.HARDWARE``). ``cost_raw`` and
``collective_bytes_raw`` equal ``cost`` and ``collective_bytes`` (the
traced count needs no correction). Beyond them: ``params_per_device``,
the ten largest live tensors at the peak and the live bytes there by
the operation that made them, collectives by kind and axis, and kernel
launches. ``--shard-cache-seq`` and ``--a2a`` take the
reference's meanings, ``--bf16-gather`` is ``gather_in_compute_dtype``;
``--no-seq-shard`` is accepted and changes nothing: the port has no
sequence sharding of the residual stream (the reference's XLA layout
hint), which the record says.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import ARCHITECTURES, SHAPES
from repro_torch.configs.base import CollectiveConfig, ParallelConfig
from repro_torch.launch import accounting as acct
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step, serve_plan


def parallel_for(arch: str, shape_kind: str) -> ParallelConfig:
    # FSDP for the archs whose optimizer state cannot replicate over data;
    # arctic's 480B params don't fit a device even at serve time with
    # model-axis sharding alone, so its weights shard over data always.
    big = arch in ("arctic-480b", "glm4-9b", "chatglm3-6b",
                   "llava-next-mistral-7b", "qwen2.5-3b", "olmoe-1b-7b",
                   "whisper-large-v3", "zamba2-2.7b")
    fsdp = (big and shape_kind == "train") or arch == "arctic-480b"
    return ParallelConfig(
        shard_params_over_data=fsdp,
        remat="full" if shape_kind == "train" else "none",
    )


def _acct_cfg(cfg, units: int):
    """Config with ``units`` homogeneous layer-units (hybrid unit = one
    mamba group + shared attention application; encdec unit = one encoder +
    one decoder layer)."""
    if cfg.family == "hybrid":
        return cfg.replace(num_layers=units * cfg.attn_every)
    if cfg.family == "encdec":
        return cfg.replace(num_layers=units, encoder_layers=units)
    return cfg.replace(num_layers=units)


def _units(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def trace_step(cfg, shape, parallel, coll, mesh, **kw):
    """One rank's step traced on ``meta``: ``(counter, step, args)``
    (``accounting.trace``'s counter, with ``memory``)."""
    step = build_step(cfg, shape, parallel, coll, mesh, device="meta", **kw)
    args = step.example_args()
    counter, _ = acct.trace(step.fn, *args)
    return counter, step, args


def accounting_metrics(cfg, shape, parallel, coll, mesh, **kw) -> dict:
    """FLOPs / bytes / collective bytes of one rank's step, and the check
    of their per-unit extrapolation.

    The reference lowers its step at 1 and 2 layer units and
    extrapolates, corrected = f(1) + (U - 1) * (f(2) - f(1)), because
    XLA counts a loop body once. The port traces 1 and 2 units and full
    depth; the full-depth count is the result, and the extrapolation
    must equal it exactly (else AssertionError naming what differs).
    ``trace``: the full-depth counter."""
    def measure(c) -> dict:
        counter, _, _ = trace_step(c, shape, parallel, coll, mesh, **kw)
        return {"flops": counter.flops, "bytes": counter.bytes,
                "coll": counter.record.totals(), "counter": counter}

    f1 = measure(_acct_cfg(cfg, 1))
    f2 = measure(_acct_cfg(cfg, 2))
    full = measure(cfg)
    U = _units(cfg)

    def extrap(a, b):
        return a + (U - 1) * (b - a)

    bad = [f"{what}: {extrap(a, b)} extrapolated, {got} traced"
           for what, a, b, got in (
               [("flops", f1["flops"], f2["flops"], full["flops"]),
                ("bytes", f1["bytes"], f2["bytes"], full["bytes"])]
               + [(f"collective {k}", f1["coll"][k], f2["coll"][k],
                   full["coll"][k]) for k in full["coll"]])
           if extrap(a, b) != got]
    if bad:
        raise AssertionError(f"{cfg.name}: the per-unit program is not "
                             f"uniform over {U} units: {'; '.join(bad)}")
    return {
        "flops": full["flops"],
        "bytes": full["bytes"],
        "coll": full["coll"],
        "per_unit_flops": f2["flops"] - f1["flops"],
        "units": U,
        "extrapolation": "exact",
        "trace": full["counter"],
    }


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            coll_algorithm: str = "xla", a2a_algorithm: str = "xla",
            shard_cache_seq: bool = False, bf16_gather: bool = False,
            seq_shard: bool = True, ssm_chunk: int = 0,
            out_dir: str = "experiments/dryrun") -> dict:
    cfg = ARCHITECTURES[arch]
    if ssm_chunk:
        cfg = cfg.replace(ssm_chunk=ssm_chunk)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "collective": coll_algorithm, "a2a": a2a_algorithm,
           "status": "ok"}

    if shape.kind == "decode":
        plan = serve_plan(cfg, shape)
        if not plan.run:
            rec.update(status="skip", reason=plan.reason)
            return _write(rec, out_dir, _tag(
                rec, coll_algorithm, a2a_algorithm, shard_cache_seq,
                bf16_gather, seq_shard, ssm_chunk))

    mesh, topology = make_production_mesh(multi_pod=multi_pod)
    rec["topology"] = " > ".join(f"{lv.name}({lv.size})"
                                 for lv in reversed(topology.levels))
    chips = mesh.size
    parallel = parallel_for(arch, shape.kind)
    if bf16_gather:
        parallel = dataclasses.replace(parallel, gather_in_compute_dtype=True)
    if not seq_shard:
        parallel = dataclasses.replace(parallel, seq_shard_activations=False)
        rec["seq_shard"] = ("not taken: the port has no sequence sharding "
                            "of the residual stream (an XLA layout hint in "
                            "the reference); the step is unchanged")
    coll = CollectiveConfig(algorithm=coll_algorithm,
                            a2a_algorithm=a2a_algorithm)

    kw = {}
    if shape.kind == "decode":
        kw["shard_cache_seq"] = shard_cache_seq
    t0 = time.time()
    acct_m = accounting_metrics(cfg, shape, parallel, coll, mesh, **kw)
    rec["trace_s"] = round(time.time() - t0, 1)
    counter = acct_m["trace"]
    rec["hardware"] = dict(acct.HARDWARE)
    rec["memory"] = dict(counter.memory)
    peak = counter.memory["peak_bytes_per_device"]
    rec["fits_hbm"] = bool(peak < acct.HBM_BYTES)
    rec["memory"]["largest_at_peak"] = counter.largest(10)
    rec["memory"]["by_op_at_peak"] = [list(x) for x in counter.by_op(10)]
    coll_b = counter.record.totals()
    rec["cost_raw"] = {"flops": float(acct_m["flops"]),
                       "bytes_accessed": float(acct_m["bytes"])}
    rec["collective_bytes_raw"] = coll_b
    rec["cost"] = {"flops": float(acct_m["flops"]),
                   "bytes_accessed": float(acct_m["bytes"]),
                   "per_unit_flops": float(acct_m["per_unit_flops"]),
                   "units": acct_m["units"],
                   "extrapolation": acct_m["extrapolation"]}
    rec["collective_bytes"] = coll_b
    rec["collectives_by_axis"] = counter.record.by_kind()
    rec["kernel_launches"] = dict(counter.kernels)
    rec["params_per_device"] = int(counter.params)
    mf = acct.model_flops(cfg, shape)
    roof = acct.roofline({"flops": acct_m["flops"],
                          "bytes accessed": acct_m["bytes"]}, coll_b,
                         chips=chips, model_flops_global=mf)
    rec["roofline"] = roof.as_dict()

    return _write(rec, out_dir, _tag(rec, coll_algorithm, a2a_algorithm,
                                     shard_cache_seq, bf16_gather, seq_shard,
                                     ssm_chunk))


def _tag(rec, coll_algorithm, a2a_algorithm, shard_cache_seq, bf16_gather,
         seq_shard, ssm_chunk) -> str:
    tag = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}_{coll_algorithm}"
    if a2a_algorithm != "xla":
        tag += f"_a2a-{a2a_algorithm}"
    if shard_cache_seq:
        tag += "_seqshard"
    if bf16_gather:
        tag += "_bf16gather"
    if not seq_shard:
        tag += "_noseqshard"
    if ssm_chunk:
        tag += f"_chunk{ssm_chunk}"
    return tag


def _write(rec: dict, out_dir: str, tag: str) -> dict:
    """Write ``rec`` as ``out_dir/tag.json`` (a skipped combination too,
    so the report shows its reason)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES))
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--collective", default="xla")
    ap.add_argument("--a2a", default="xla")
    ap.add_argument("--shard-cache-seq", action="store_true")
    ap.add_argument("--bf16-gather", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--ssm-chunk", type=int, default=0)
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("name --arch and --shape, or pass --all")

    combos = ([(a, s) for a in sorted(ARCHITECTURES) for s in SHAPES]
              if args.all else [(args.arch, args.shape)])
    failures = 0
    for arch, shape in combos:
        try:
            rec = run_one(arch, shape, multi_pod=args.multipod,
                          coll_algorithm=args.collective,
                          a2a_algorithm=args.a2a,
                          shard_cache_seq=args.shard_cache_seq,
                          bf16_gather=args.bf16_gather,
                          seq_shard=not args.no_seq_shard,
                          ssm_chunk=args.ssm_chunk,
                          out_dir=args.out)
            roof = rec.get("roofline", {})
            print(f"[{rec['status']:4s}] {arch:24s} {shape:12s} "
                  f"{rec['mesh']:8s} "
                  f"peak={rec.get('memory', {}).get('peak_bytes_per_device', 0) / 1e9:6.2f}GB "
                  f"dom={roof.get('dominant', '-'):10s} "
                  f"(trace {rec.get('trace_s', 0)}s)"
                  + (f" SKIP: {rec.get('reason', '')[:60]}"
                     if rec["status"] == "skip" else ""),
                  flush=True)
        except Exception as e:
            failures += 1
            print(f"[FAIL] {arch} {shape}: {type(e).__name__}: {e}",
                  flush=True)
            traceback.print_exc()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
