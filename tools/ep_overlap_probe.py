"""Probe: the backward-overlapped sync thread under expert parallelism.

    python3 tools/ep_overlap_probe.py        # needs a CUDA device and nvcc

Under expert parallelism the training step syncs each layer inside the
backward (``steps.build_train_step``: ``release_sink(overlap=ep_axis is
None)``) because the sync thread, on one card, once lost a gloo
connection in the second overlapped step and once the machine
(ROADMAP.md Queue 3). This script puts the thread back for its own run
only: every process (the ranks re-import this file) wraps
``Communicator.release_sink`` to pass ``overlap=True``. It then runs
``chip_smoke.py``'s [8m] (olmoe-1b-7b at full width, 2 of 16 layers, 4
ranks on ("data", "model") = 2 x 2, tuned and ``"xla"``), frees the
runs' trees as [8m] does, and [8mc] (the tuned run with
``--overlap-backward``, now on the sync thread) ``REPEATS`` times, to
tell a rare fault from none, holding each to [8m]'s tuned run: step 0's
synced gradients within ``TRAIN_GRAD_TOL``, losses within
``TRAIN_LOSS_TOL``, the sync thread busy in every step.

Once a second every process appends a line to ``mem.<pid>.log`` in
``build/ep_probe/`` (``EP_PROBE_LOG_DIR`` moves it; the ranks inherit
it): its role (launcher or rank), the host's available memory and this
process's resident memory (``/proc``), and, in a rank, its CUDA memory
allocated and reserved.
The last line printed is ``probe: ok`` or the error.
"""
from __future__ import annotations

import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
LOG_DIR = os.environ.get("EP_PROBE_LOG_DIR",
                         os.path.join(ROOT, "build", "ep_probe"))
#: overlapped runs on the sync thread, each held to [8m]'s tuned run
REPEATS = 3


def _meminfo_kib(key: str, path: str = "/proc/meminfo") -> int:
    with open(path) as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1])
    return -1


def _watch(role: str) -> None:
    """A daemon thread: one line a second into this process's log."""
    os.makedirs(LOG_DIR, exist_ok=True)
    path = os.path.join(LOG_DIR, f"mem.{os.getpid()}.log")

    def run():
        import torch
        t0 = time.time()
        while True:
            cuda = ""
            if role == "rank" and torch.cuda.is_initialized():
                cuda = (f" cuda_alloc_mib "
                        f"{torch.cuda.memory_allocated() >> 20} "
                        f"cuda_reserved_mib "
                        f"{torch.cuda.memory_reserved() >> 20}")
            with open(path, "a") as f:
                f.write(f"{time.time() - t0:.1f} {role} host_avail_mib "
                        f"{_meminfo_kib('MemAvailable') >> 10} rss_mib "
                        f"{_meminfo_kib('VmRSS', '/proc/self/status') >> 10}"
                        f"{cuda}\n")
            time.sleep(1.0)
    threading.Thread(target=run, daemon=True).start()


def _thread_back() -> None:
    """Every release sink of this process syncs on the thread."""
    from repro_torch.comms import communicator as C
    orig = C.Communicator.release_sink

    def release_sink(self, *args, overlap=False, **kw):
        return orig(self, *args, overlap=True, **kw)
    C.Communicator.release_sink = release_sink


_thread_back()
if __name__ != "__main__":          # a spawned rank re-importing this file
    _watch("rank")


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch import pytree
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _watch("launcher")
    cs.phase_device()
    tuned = cs.train_run("8m", "tuned", [*cs.MOE_TRAIN_ARGS,
                                         "--tuning-table", cs.FLAT_TABLE],
                         config=cs.MOE_TRAIN_CONFIG)
    xla = cs.train_run("8m", "xla", [*cs.MOE_TRAIN_ARGS, "--collective",
                                     "xla"], config=cs.MOE_TRAIN_CONFIG)
    for label, r in (("tuned", tuned), ("xla", xla)):
        cs.check_moe_run("8m", label, r)
    rd = cs.sync_readings(tuned, xla)
    cs.log(f"    tuned vs xla: gradients {rd['grad']:.3g}, change "
           f"{rd['change']:.3g}")
    for k in ("init_params", "params"):
        tuned.pop(k), xla.pop(k)
    xla.pop("grads0")
    for k in range(REPEATS):
        r = cs.train_run("8mc", f"tuned, overlapped on the sync thread "
                         f"({k + 1} of {REPEATS})",
                         [*cs.MOE_TRAIN_ARGS[:-5], str(cs.MOE_OVERLAP_STEPS),
                          *cs.MOE_TRAIN_ARGS[-4:], "--tuning-table",
                          cs.FLAT_TABLE, "--overlap-backward"],
                         config=cs.MOE_TRAIN_CONFIG)
        cs.check_moe_run("8mc", "overlapped", r, cs.MOE_OVERLAP_STEPS)
        grad = cs.grad_reading(pytree.leaves(r["grads0"]),
                               pytree.leaves(tuned["grads0"]))
        loss = max(abs(a - b) for a, b in zip(r["losses"],
                                              tuned["losses"]))
        for i in range(cs.MOE_OVERLAP_STEPS):
            cs.log(f"    step {i}: compute / exposed sync / optimizer s "
                   f"{r['compute_s'][i]:.4f} / {r['sync_s'][i]:.4f} / "
                   f"{r['opt_s'][i]:.4f}, sync thread "
                   f"{r['release_sync_s'][i]:.4f}; [8m] tuned "
                   f"{tuned['compute_s'][i]:.4f} / {tuned['sync_s'][i]:.4f}")
        cs.log(f"    overlapped on the thread vs [8m] tuned: gradients "
               f"{grad:.3g} (tol {cs.TRAIN_GRAD_TOL}), losses {loss:.3g} "
               f"(tol {cs.TRAIN_LOSS_TOL}); release events "
               f"{r['release_events']}")
        if grad > cs.TRAIN_GRAD_TOL or loss > cs.TRAIN_LOSS_TOL or \
                not all(r["release_sync_s"]):
            raise AssertionError("the overlapped run departs from [8m]'s")
        del r
    print("probe: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
