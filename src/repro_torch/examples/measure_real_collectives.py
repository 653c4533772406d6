"""Measure the port's collective algorithms for real and tune from those
measurements (port of ``examples/measure_real_collectives.py``): the
``DeviceBackend`` path of the Benchmark Executor, inside a group of
``gloo`` ranks on the card (payloads staged through the host) or on the
host (``--device cpu``), through `launch.measure_collectives`. The ops
``all_reduce`` and ``broadcast`` at 4 KB, 256 KB and 4 MB, 3 trials,
the ``exhaustive`` tuner, over 8 ranks (the reference's 8 devices); the
best table lands in ``OUT/device_measured_decision.json``, which
``repro.core.tuning.DecisionTable.load`` reads too.

Run:  PYTHONPATH=src python -m repro_torch.examples.measure_real_collectives
"""
from __future__ import annotations

import argparse
import os

from repro_torch.launch import measure_collectives

SIZES = (4096, 262144, 4 << 20)
OUT_NAME = "device_measured_decision.json"


def run(out: str = ".", *, device="cuda", ranks: int = 8,
        trials: int = 3) -> dict:
    """The measured tuning run; returns `measure_collectives.main`'s
    result (its table at ``out/device_measured_decision.json``)."""
    os.makedirs(out, exist_ok=True)
    return measure_collectives.main([
        "--device", device, "--ranks", str(ranks), "--trials", str(trials),
        "--sizes", *map(str, SIZES), "--tuners", "exhaustive",
        "--out", os.path.join(out, OUT_NAME)])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=".",
                    help="directory of the artifact (default: here)")
    args = ap.parse_args(argv)
    return run(args.out, device=args.device)


if __name__ == "__main__":
    main()
