"""Before and after of the rank transport on one card, in one call.

    python3 tools/transport_ab.py PARENT      # needs a CUDA device and nvcc

``PARENT`` is an unpacked checkout of the commit before the arena
transport (its ``core/collectives/group.py`` stages every CUDA payload
through host memory); this file's own checkout is the change. Each
measurement runs in a fresh process with one tree's ``src`` first on
the path (its kernels built in that tree's ``build/``), 4 ranks on the
card:

- ``allreduce``: 64 MB of fp32 all-reduced over the 4 ranks, the ring in
  2 segments (every reduce step in the ``segment_combine`` kernel) and
  the built-in sum (``"xla"``), one warm-up and ``TRIALS`` timed runs,
  each the slowest rank's seconds; in turns parent, change, change,
  parent;
- ``train8``: ``chip_smoke.py``'s [8] tuned run of smollm-135m (2 x 2,
  the hierarchical table, 2 steps);
- ``train8t``: its [8t] tuned run (tensor parallelism, 2 x 2);
- ``train8ftb``: its [8ft] (b) run (whisper-large-v3 at full depth
  under FSDP + tensor parallelism, 1 step);

each training run once a tree, parent first: every step's forward and
backward, sync and optimizer seconds, and the model-axis, gather and
reduce-scatter seconds inside the forward and backward, the slowest
rank's. Every result is a JSON line beginning ``ab:``; the card's name
and power limit come first.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIALS = 3
ELEMS = (64 << 20) // 4
TRAIN = {
    "train8": (["--arch", "smollm-135m", "--ranks", "4", "--topology",
                "2x2", "--steps", "2", "--seq", "256", "--batch", "8",
                "--tuning-table", "examples/artifacts/"
                "hierarchical_decision.json"], None),
    "train8t": (["--arch", "smollm-135m", "--ranks", "4",
                 "--model-parallel", "2", "--seq", "256", "--batch", "8",
                 "--steps", "2", "--tuning-table",
                 "examples/artifacts/tuned_decision.json"], None),
    "train8ftb": (["--arch", "whisper-large-v3", "--ranks", "4",
                   "--model-parallel", "2", "--seq", "256", "--collective",
                   "xla", "--steps", "1", "--batch", "2"],
                  {"shard_params_over_data": True,
                   "gather_in_compute_dtype": True}),
}
KEEP = ("step_s", "compute_s", "sync_s", "opt_s", "model_s", "gather_s",
        "reduce_scatter_s", "losses")


def _allreduce_rank():
    import torch
    import torch.distributed as dist
    from repro_torch.core.collectives import group as grp
    from repro_torch.core.collectives.algorithms import ALGORITHMS
    dev = grp.device_of("cuda")
    x = torch.ones(ELEMS, device=dev)
    ring = ALGORITHMS["all_reduce"]["ring"]
    out = {}
    for label, fn in (("ring/s2", lambda: ring(x, None, 4, segments=2)),
                      ("xla", lambda: grp.psum(x))):
        ts = []
        for _ in range(1 + TRIALS):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            y = fn()
            torch.cuda.synchronize()
            ts.append(grp.max_over_ranks([time.perf_counter() - t0])[0])
        if not bool((y == 4).all()):
            raise AssertionError(f"{label}: wrong sum")
        out[label] = ts[1:]
    return out


def worker(what: str) -> dict:
    """One measurement on this process's tree (``src`` first on the path)."""
    os.chdir(HERE)
    if what == "allreduce":
        from repro_torch.core.collectives import group as grp
        return grp.spawn(_allreduce_rank, 4)
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch import train
    argv, parallel = TRAIN[what]
    res = train.main(argv, keep_params=False,
                     parallel=ParallelConfig(**parallel) if parallel
                     else None)
    return {k: res[k] for k in KEEP if k in res}


def run(tree: str, what: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--worker", tree, what], env=env,
                         capture_output=True, text=True, timeout=1200)
    if out.returncode != 0:
        raise RuntimeError(f"{tree} {what}: {out.stderr[-3000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["wall_s"] = time.perf_counter() - t0
    return res


def main(parent: str) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"ab: {json.dumps({'card': smi})}", flush=True)
    trees = {"parent": os.path.abspath(parent), "change": HERE}
    for label in ("parent", "change", "change", "parent"):
        res = run(trees[label], "allreduce")
        print(f"ab: {json.dumps({'tree': label, 'allreduce': res})}",
              flush=True)
    for what in TRAIN:
        for label in ("parent", "change"):
            res = run(trees[label], what)
            print(f"ab: {json.dumps({'tree': label, what: res})}",
                  flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        sys.path.insert(0, os.path.join(sys.argv[2], "src"))
        print(json.dumps(worker(sys.argv[3])), flush=True)
    elif len(sys.argv) == 2:
        sys.exit(main(sys.argv[1]))
    else:
        sys.exit(__doc__)
