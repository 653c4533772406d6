"""Run ``chip_smoke.py``'s [8ft] (b) and [8mf] training runs and then its
[9] accounting phase alone, on one card: a quicker check of the
dry-run's trace against the measured steps than the whole script.

    python3 tools/accounting_probe.py

[8mf] keeps its params as in the script (``keep=True``); the training
runs print their lines, [9] its checks, and the last lines give each
rank's step peaks and the phase's summary (without the dry-runs'
records, which it writes under ``build/dryrun/``). Exits nonzero
without a CUDA device."""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("accounting_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as c
    from repro_torch.configs.base import ParallelConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    smi = c.phase_device()
    b = c.train_run("8ft", "(b) full depth",
                    [*c.FSDP_MODEL_ARGS, *c.FSDP_MODEL_FULL],
                    parallel=ParallelConfig(shard_params_over_data=True,
                                            gather_in_compute_dtype=True),
                    keep=False)
    m = c.train_run("8mf", "olmoe FSDP + EP",
                    [*c.MOE_TRAIN_ARGS, "--collective", "xla"],
                    config=c.MOE_TRAIN_CONFIG,
                    parallel=ParallelConfig(shard_params_over_data=True),
                    keep=True)
    print("STEP_PEAKS", b["step_peak_bytes"], m["step_peak_bytes"],
          b["peak_mem_bytes"], m["peak_mem_bytes"], flush=True)
    s = c.phase_accounting({"full": b, "olmoe": m}, smi)
    print(json.dumps({k: v for k, v in s.items()
                      if not k.startswith("dryrun")}, default=str))
    print("TOTAL", time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
