"""Render tables from the dry-run's JSON records (port of
``repro/launch/report.py``): ``python -m repro_torch.launch.report
[DIR]`` prints the single-pod table, its roofline and the multi-pod
table of the records in DIR (default ``experiments/dryrun``).

The columns name the H100 the records are priced against (``fits
80GB``, the trace's seconds where the reference shows its compile's);
the levers are the reference's, but where one names a TPU thing."""
from __future__ import annotations

import glob
import json
import os
import sys


VARIANT_MARKERS = ("seqshard", "bf16gather", "a2a-", "noseqshard", "_chunk")


def load(out_dir="experiments/dryrun", include_variants=False):
    recs = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        if not include_variants and any(m in os.path.basename(f)
                                        for m in VARIANT_MARKERS):
            continue
        with open(f) as fh:
            rec = json.load(fh)
        rec["_file"] = os.path.basename(f)
        recs.append(rec)
    return recs


def fmt_bytes(b):
    return f"{b / 1e9:.2f}"


def dryrun_table(recs, mesh="16x16", collective="xla"):
    rows = ["| arch | shape | status | peak GB/dev | fits 80GB | GFLOPs/dev"
            " | GB/dev | coll GB/dev | trace s |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh or r["collective"] != collective:
            continue
        if r["status"] == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | SKIP | - | - | - |"
                        f" - | - | - |")
            continue
        roof = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok "
            f"| {fmt_bytes(r['memory']['peak_bytes_per_device'])} "
            f"| {'Y' if r['fits_hbm'] else 'N'} "
            f"| {roof['flops_per_device'] / 1e9:.1f} "
            f"| {fmt_bytes(roof['bytes_per_device'])} "
            f"| {fmt_bytes(roof['coll_bytes_per_device'])} "
            f"| {r.get('trace_s', 0)} |")
    return "\n".join(rows)


def roofline_table(recs, mesh="16x16", collective="xla"):
    rows = ["| arch | shape | compute ms | memory ms | collective ms |"
            " dominant | useful ratio | bottleneck lever |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh or r["collective"] != collective:
            continue
        if r["status"] == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | - | - | - | SKIP |"
                        f" - | {r.get('reason', '')[:60]} |")
            continue
        roof = r["roofline"]
        lever = {
            "compute": "more devices / lower precision",
            "memory": ("shard KV cache seq over model axis"
                       if r["shape"].startswith(("decode", "long"))
                       else "activation sharding / remat policy"),
            "collective": ("tuned ring/segmented schedule or 2D sharding"
                           if r["shape"] == "train_4k"
                           else "avoid replicated-cache attention psum"),
        }[roof["dominant"]]
        rows.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {roof['compute_s'] * 1e3:.2f} | {roof['memory_s'] * 1e3:.2f} "
            f"| {roof['collective_s'] * 1e3:.2f} | **{roof['dominant']}** "
            f"| {roof['useful_ratio']:.3f} | {lever} |")
    return "\n".join(rows)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    recs = load(argv[0] if argv else "experiments/dryrun")
    print("## single-pod 16x16\n")
    print(dryrun_table(recs))
    print("\n## roofline\n")
    print(roofline_table(recs))
    print("\n## multi-pod 2x16x16\n")
    print(dryrun_table(recs, mesh="2x16x16"))


if __name__ == "__main__":
    main()
