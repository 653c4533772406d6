"""Serve a small model with batched requests (port of
``examples/serve_decode.py``): the prompt fed through the KV cache
token by token, then greedy decode, with the full cache and a sliding
window of 16 (the long-context variant). Prints tok/s per mode.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode
      PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.registry import build_model

B, PROMPT_LEN, GEN = 4, 24, 24
WINDOWS = (0, 16)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, *, window: int, device="cuda", compute_dtype=torch.bfloat16,
        params=None) -> dict:
    """One mode: ``B`` prompts of ``PROMPT_LEN`` tokens (numpy's
    generator seeded 0) through ``decode_step``, then ``GEN`` greedy
    tokens. ``params``: the model's tree (default: drawn from a
    generator seeded 0 on the device). Returns the new tokens ``(B,
    GEN)`` and the decode loop's tok/s."""
    api = build_model(cfg, window=window, compute_dtype=compute_dtype,
                      device=device)
    dev = api.device
    if params is None:
        params = api.init(torch.Generator(device=dev).manual_seed(0))
    cache = api.init_cache(B, window or (PROMPT_LEN + GEN))
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (B, PROMPT_LEN))).to(dev)
    with torch.no_grad():
        for i in range(PROMPT_LEN):
            logits, cache = api.decode_step(params, cache, prompt[:, i:i + 1])
        tok = torch.argmax(logits, -1)[:, None]
        out = []
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(GEN):
            out.append(tok)
            logits, cache = api.decode_step(params, cache, tok)
            tok = torch.argmax(logits, -1)[:, None]
        _sync(dev)
    dt = time.perf_counter() - t0
    tokens = torch.cat(out, 1).cpu()
    mode = f"sliding-window({window})" if window else "full-cache"
    print(f"{mode:20s} batch={B} {B * GEN / dt:7.1f} tok/s "
          f"first tokens: {tokens[0, :8].tolist()}", flush=True)
    return {"tokens": tokens, "tok_per_s": B * GEN / dt, "decode_s": dt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cfg = get_config("smollm-135m").reduced()
    return {w: run(cfg, window=w, device=args.device) for w in WINDOWS}


if __name__ == "__main__":
    main()
