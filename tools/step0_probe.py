"""Where a training run's fixed cost goes: the seconds a spawned group
takes to start, and, for one ``launch.train`` run, every rank's stamps
(its function entered, the step built, each step's start and length)
and the modules step 0 imported (a lazy import on the step's path is
paid again in every new rank).

On the card, smollm-135m at full width and depth, ``"xla"``, 2 steps on
1 rank (batch 2) and on 4 ranks (2x2, batch 8):

    python3 tools/step0_probe.py

On the host at a small size:

    python3 tools/step0_probe.py --device cpu --reduced --seq 32
"""
import argparse
import os
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))


def _noop():
    return None


def _stamped_rank(opts):
    """``launch.train``'s rank function with stamps around its steps."""
    from repro_torch.core.collectives import group as grp
    from repro_torch.launch import train
    t0 = float(os.environ["STEP0_PROBE_T0"])
    r = grp.rank()

    def say(msg):
        print(f"  rank {r} {msg} at {time.time() - t0:.2f}s", flush=True)
    say("entered")
    build = train.build_train_step

    def stamped_build(*a, **k):
        step = build(*a, **k)
        say("built its step")
        fn, calls = step.fn, [0]

        def stamped_fn(*aa, **kk):
            i, before, t = calls[0], set(sys.modules), time.time()
            calls[0] += 1
            out = fn(*aa, **kk)
            new = sorted(set(sys.modules) - before)
            say(f"ended step {i} ({time.time() - t:.2f}s)")
            if r == 0:
                print(f"  step {i} imported {len(new)} modules: "
                      f"{', '.join(new[:12])}", flush=True)
            return out
        step.fn = stamped_fn
        return step
    train.build_train_step = stamped_build
    return train._rank_main(opts)      # this process's own, unpatched


def run(argv):
    from repro_torch.launch import train
    os.environ["STEP0_PROBE_T0"] = repr(time.time())
    t = time.time()
    print(f"== train {' '.join(argv)}", flush=True)
    train.main(argv, keep_params=True)
    print(f"== {time.time() - t:.2f}s in all", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()
    from repro_torch.core.collectives import group as grp
    from repro_torch.launch import train
    for i in range(3):
        t = time.time()
        grp.spawn(_noop, 4)
        print(f"a 4-rank group of nothing: {time.time() - t:.2f}s", flush=True)
    # the ranks run train's own function, stamped
    train._rank_main = _stamped_rank
    base = ["--arch", "smollm-135m", "--device", args.device, "--seq",
            str(args.seq), "--steps", "2", "--collective", "xla",
            *(["--reduced"] if args.reduced else [])]
    run([*base, "--ranks", "1", "--batch", "2"])
    run([*base, "--ranks", "4", "--batch", "8", "--topology", "2x2"])


if __name__ == "__main__":
    main()
