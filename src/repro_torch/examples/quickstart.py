"""Quickstart (port of ``examples/quickstart.py``): train the reduced
smollm-135m on a data x model mesh of ranks with the paper's technique,
the gradient all-reduce through a hand-written algorithm (``ring``,
``rabenseifner``: every reduce step in the ``segment_combine`` kernel on
the card), against the backend's own (``xla``), through
`launch.train`. The reference's mesh is ``make_local_mesh(
model_parallel=2)`` over 8 devices, data 4 x model 2: here 8 ranks
(``--topology 4x2``, data x model).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      PYTHONPATH=src python -m repro_torch.examples.quickstart \\
          --device cpu --topology 2x2 --steps 2
"""
from __future__ import annotations

import argparse
import time

from repro_torch.launch import train as launch_train

ALGORITHMS = ("xla", "ring", "rabenseifner")


def train(collective: str, *, steps: int = 10, topology=(4, 2),
          device="cuda") -> dict:
    """`launch.train` of the reduced smollm-135m at seq 128, global batch
    8, lr 1e-3 on ``topology`` = (data, model) ranks with the gradient
    sync ``collective``; returns rank 0's result with its wall seconds."""
    data, model = topology
    t0 = time.perf_counter()
    res = launch_train.main([
        "--arch", "smollm-135m", "--reduced", "--seq", "128", "--batch", "8",
        "--lr", "1e-3", "--steps", str(steps), "--collective", collective,
        "--ranks", str(data * model), "--model-parallel", str(model),
        "--device", device])
    res["wall_s"] = time.perf_counter() - t0
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--topology", default="4x2",
                    help="data x model ranks")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    topology = tuple(int(x) for x in args.topology.split("x"))
    print(f"ranks: {topology[0] * topology[1]} (mesh {topology[0]}x"
          f"{topology[1]} data x model)")
    out = {}
    for algo in ALGORITHMS:
        res = out[algo] = train(algo, steps=args.steps, topology=topology,
                                device=args.device)
        losses = res["losses"]
        print(f"gradient sync = {algo:13s} loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}  ({res['wall_s']:.1f}s)")
    print("same trajectory under every algorithm — the tuner is free to "
          "pick per message size without changing training semantics.")
    return out


if __name__ == "__main__":
    main()
