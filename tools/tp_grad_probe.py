"""How far apart two correct layouts of one training step read: step 0 of
smollm-135m's ``"xla"`` training (8 rows, seed 0) on ``("data",
"model")`` = 4 x 1, 2 x 1 (two ranks) and 2 x 2 (tensor-parallel), in
bf16 and fp32 compute; prints, for each pair, the loss difference and
the worst leaf of step 0's synced gradients (gathered over ``model``)
by relative 2-norm, by max|diff| / max|want| and by the allclose form
of ``chip_smoke.allclose_reading`` (max |diff| / (max|want| + |want|)).

All runs go through ``launch.train.main`` in this one process, so they
draw one batch (the data streams hash their names with the process's
salt). On the card, full width and depth, 256 tokens a row (~5 min):

    python3 tools/tp_grad_probe.py

On the host at a small size, e.g. 30 layers of the reduced model with
smollm's whole-attention layout (3 heads over 1 kv head):

    python3 tools/tp_grad_probe.py --device cpu --reduced --seq 128 \\
        --config num_layers=30 num_heads=3 num_kv_heads=1 d_model=192
"""
import argparse
import itertools
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

LAYOUTS = {"4x1": ["--ranks", "4"], "2x1": ["--ranks", "2"],
           "2x2": ["--ranks", "4", "--model-parallel", "2"]}


def readings(got, want, device):
    """(relative 2-norm, max|diff| / max|want|, allclose form): each the
    worst leaf's, in float64 on ``device``."""
    norm2 = maxrel = allclose = 0.0
    for g, w in zip(got, want):
        g, w = g.to(device, torch.float64), w.to(device, torch.float64)
        d, top = (g - w).abs(), w.abs().max()
        norm2 = max(norm2, ((g - w).norm() / w.norm()).item())
        maxrel = max(maxrel, (d.max() / top).item())
        allclose = max(allclose, (d / (top + w.abs())).max().item())
    return norm2, maxrel, allclose


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--config", nargs="*", default=[],
                    help="fields of the model's config, name=int")
    args = ap.parse_args()
    from repro_torch import pytree
    from repro_torch.configs import ParallelConfig
    from repro_torch.launch import train
    if args.device == "cuda":
        print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                       "--format=csv,noheader").read().strip(), flush=True)
    config = {k: int(v) for k, v in (c.split("=") for c in args.config)}
    base = ["--arch", "smollm-135m", "--seq", str(args.seq), "--batch", "8",
            "--steps", "1", "--collective", "xla", "--device", args.device,
            *(["--reduced"] if args.reduced else [])]
    runs = {}
    for dtype in ("bfloat16", "float32"):
        for name, extra in LAYOUTS.items():
            if dtype == "float32" and name == "2x1":
                continue
            res = train.main([*base, *extra], keep_params=True,
                             parallel=ParallelConfig(compute_dtype=dtype),
                             config=config or None)
            runs[(dtype, name)] = (res["losses"][0], pytree.leaves(
                res.get("grads0_whole", res["grads0"])))
    for a, b in itertools.combinations(runs, 2):
        if a[0] != b[0]:
            continue
        norm2, maxrel, allclose = readings(runs[a][1], runs[b][1],
                                           args.device)
        print(f"{a[0]} {a[1]} vs {b[1]}: loss {runs[a][0] - runs[b][0]:.3g};"
              f" gradients, worst leaf: relative 2-norm {norm2:.4g}, "
              f"max|diff|/max|want| {maxrel:.4g}, allclose {allclose:.4g}",
              flush=True)


if __name__ == "__main__":
    main()
