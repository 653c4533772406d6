"""End-to-end training driver (port of ``examples/train_e2e.py``): data
pipeline -> training step -> checkpoint -> resume. Trains half the
steps, saves params and AdamW's state in the reference's layout
(`repro_torch.checkpoint`: ``repro.checkpoint.restore`` reads it),
restores them and trains the rest. Defaults to the reduced smollm-135m;
``--full`` trains the real config (30 layers, d 576). On the card every
step runs the flash-attention forward and backward kernels on each
layer; ``--device cpu`` takes their plain versions.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 15
      PYTHONPATH=src python -m repro_torch.examples.train_e2e --device cpu
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import pytree
from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticPipeline, batch_to_tensors
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamW, cosine_with_warmup


def run(cfg, *, steps: int = 15, seq: int = 128, batch: int = 4,
        ckpt: str = None, device="cuda", compute_dtype=torch.bfloat16,
        params=None) -> dict:
    """Train ``steps`` steps of ``cfg`` from ``params`` (default: drawn
    from a generator seeded 0 on the device). With ``ckpt`` the run
    checkpoints there after ``steps // 2`` steps, restores and resumes;
    without it, it runs straight through. Returns each step's loss and
    seconds, and the checkpoint's save and restore seconds."""
    shape = ShapeConfig(name="e2e", seq_len=seq, global_batch=batch,
                        kind="train")
    api = build_model(cfg, compute_dtype=compute_dtype, device=device)
    dev = api.device
    opt = AdamW(lr=1e-3)
    if params is None:
        params = api.init(torch.Generator(device=dev).manual_seed(0))
    else:       # the step updates in place: the caller's tree stays
        params = pytree.tree_map(lambda t: t.to(dev, copy=True), params)
    opt_state = opt.init(params)
    pipe = SyntheticPipeline(cfg, shape, seed=0)

    def step(params, opt_state, batch):
        leaves, treedef = pytree.flatten(params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        loss, _ = api.loss(treedef.unflatten(leaves), batch)
        grads = treedef.unflatten(list(torch.autograd.grad(loss, leaves)))
        lr_scale = cosine_with_warmup(opt_state.step, warmup_steps=5,
                                      total_steps=steps)
        params, opt_state = opt.update(grads, opt_state, params,
                                       lr_scale=lr_scale)
        return params, opt_state, loss.detach()

    out = {"losses": [], "step_s": [], "save_s": None, "restore_s": None}

    def train(params, opt_state, start, stop):
        for i in range(start, stop):
            t0 = time.perf_counter()
            params, opt_state, loss = step(
                params, opt_state, batch_to_tensors(pipe.batch_at(i), dev))
            out["losses"].append(float(loss))       # waits for the step
            out["step_s"].append(time.perf_counter() - t0)
            print(f"step {i:3d} loss {out['losses'][-1]:.4f}", flush=True)
        return params, opt_state

    half = steps // 2 if ckpt else steps
    params, opt_state = train(params, opt_state, 0, half)
    if ckpt:
        t0 = time.perf_counter()
        save(ckpt, {"params": params, "opt": opt_state}, step=half)
        out["save_s"] = time.perf_counter() - t0
        print(f"checkpointed at step {half}; resuming...", flush=True)
        t0 = time.perf_counter()
        restored, start, _ = restore(ckpt, {"params": params,
                                            "opt": opt_state})
        out["restore_s"] = time.perf_counter() - t0
        del params, opt_state
        params, opt_state = train(restored["params"], restored["opt"],
                                  start, steps)
    print("done.", flush=True)
    out["params"] = params
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--full", action="store_true",
                    help="the real smollm-135m config")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default=".",
                    help="directory of the checkpoint (default: here)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: "
                         "OUT/repro_e2e_ckpt)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cfg = get_config("smollm-135m")
    if not args.full:
        cfg = cfg.reduced()
    return run(cfg, steps=args.steps, seq=args.seq, batch=args.batch,
               ckpt=args.ckpt or os.path.join(args.out, "repro_e2e_ckpt"),
               device=args.device)


if __name__ == "__main__":
    main()
