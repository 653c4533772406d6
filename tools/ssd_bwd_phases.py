"""Where the time of the bf16 SSD chunk backward kernel goes, phase by phase.

    python3 tools/ssd_bwd_phases.py        # needs a CUDA device and nvcc

Builds ``src/repro_torch/csrc/ssd_chunk_bwd.cu`` with ``-DSSD_BWD_PHASES``
(through ``repro_torch.kernels._build``, beside the plain build), which
turns on the kernel's ``SSD_BWD_STAMP(k)`` marks: threads 0 and 128
(warps 0 and 4, the two warps of one SM sub-partition, which own row
tiles 0 and 7) stamp the device's global timer (ns) at each phase
boundary of ``ssd_chunk_bwd_mma`` and at the end of the last-arriving
cluster's sums. Runs it at mamba2-130m's and zamba2-2.7b's training
shapes (``chip_smoke.SSD_TRAIN_SHAPE``, ``SSD_ZAMBA2_TRAIN_SHAPE``) on
``chip_smoke.ssd_bwd_inputs`` with dy a transposed view, checks that its
outputs equal the plain build's bit for bit, and prints the median and
the largest time of each phase over the blocks that reach it.
"""
from __future__ import annotations

import ctypes
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFINES = ("SSD_BWD_PHASES",)
# what ends at stamp k (k = 1..12; stamp 0 is the block's start); only
# the blocks of the last cluster of a (batch, chunk) to arrive reach 12
PHASES = ["tiles loaded", "G^T, dscores^T issued", "F, scores, dG", "dx",
          "dG^T C, x dS^T issued", "dw", "block barrier", "dC",
          "scans (warp 0), barrier", "fp32 dB, dC out; cluster barrier",
          "cluster sums", "last cluster: dA's and the partials' sums"]


def phases(shape) -> None:
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan_bwd as sb
    B, S, H, P, N, Q = shape
    x, dt, A, Bm, Cm, cum, dy, dS, dcum = chip_smoke.ssd_bwd_inputs(
        shape, torch.bfloat16, seed=96)
    dy = dy.permute(0, 2, 3, 1, 4).contiguous().permute(0, 3, 1, 2, 4)
    ins = (x, dt, A, Bm, Cm, cum, dy, dS, dcum)
    want = sb.ssd_chunk_bwd(*ins, chunk=Q)
    grid = B * H * (S // Q)
    stamps = torch.zeros(grid * 32, dtype=torch.int64, device="cuda")
    set_stamps = _build.load("ssd_chunk_bwd",
                             DEFINES).repro_ssd_chunk_bwd_set_stamps
    set_stamps.argtypes, set_stamps.restype = [ctypes.c_void_p], ctypes.c_int
    rc = set_stamps(stamps.data_ptr())
    if rc != 0:
        raise RuntimeError(f"setting the stamps failed: cudaError {rc}")
    for _ in range(5):                     # warm; then one stamped call
        sb._bwd_mma(*ins, Q, defines=DEFINES)
    stamps.zero_()
    got = sb._bwd_mma(*ins, Q, defines=DEFINES)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the stamped build's outputs differ")
    st = stamps.view(grid, 2, 16).double().cpu()
    t0 = st[:, 0, 0].min()
    print(f"{shape}: {grid} blocks in clusters of {sb.cluster_size(H)}; "
          f"phase times over the blocks, median / largest, us")
    for w, label in ((0, "warp 0 (tile 0)"), (1, "warp 4 (tile 7)")):
        rel = (st[:, w] - t0) / 1e3
        parts = []
        for k, what in enumerate(PHASES, start=1):
            reached = st[:, w, k] > 0
            if not reached.any():
                continue
            d = (rel[:, k] - rel[:, k - 1])[reached]
            parts.append(f"{what} {d.median():.2f} / {d.max():.2f}"
                         + ("" if reached.all() else
                            f" ({int(reached.sum())} blocks)"))
        print(f"  {label}: " + "; ".join(parts))


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_bwd_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke
    for shape in (chip_smoke.SSD_TRAIN_SHAPE,
                  chip_smoke.SSD_ZAMBA2_TRAIN_SHAPE):
        phases(shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
