"""Serving engine: batched decode over paged KV (port of ``repro/serve/engine.py``).

Execution model
---------------
The engine owns ``max_active`` fixed request *slots*. The dense
family's cache from ``api.init_cache(batch=1, view_len)`` gives the
paged leaves, the attention ``k``/``v`` tensors, stored in a
:class:`~repro_torch.serve.paged_kv.PagedKV` block pool; the engine owns
one ``(max_active,)`` vector of lengths in place of the cache's scalar.

The reference vmaps a batch-1 ``decode_step`` over the slots. Here one
step gathers every slot's dense view through the block tables into a
``(L, max_active, view_len, KV, Dh)`` cache, runs ONE batched
``decode_step`` with the per-slot lengths, scatters each slot's newly
written token back into its blocks, and argmaxes the next token.
Inactive slots read and write the null block and keep their length. A
slot's row of the batched step depends only on its own data, so the
paged engine gives exactly the tokens of the same batched decode over
dense caches (the tests' oracle).

Timing is injected: with ``cost_model=None`` the run loop uses the wall
clock; a ``cost_model(kind, n) -> seconds`` callable switches every
duration (and the arrival clock) to deterministic simulated time. The
tensor-parallel decode of the reference comes with the collectives
slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.serve.paged_kv import PagedKV, gather_views, scatter_tokens

PAGED_LEAVES = ("k", "v")


@dataclasses.dataclass
class ServeResult:
    """Outcome of a serving run: aggregate latency/throughput + spans."""
    summary: dict
    records: list
    wall_s: float


class ServeEngine:
    @torch.inference_mode()
    def __init__(self, api, params, *, max_active: int = 4,
                 view_len: int = 64, block_size: int = 8,
                 num_blocks: Optional[int] = None):
        self.api = api
        self.params = params
        self.max_active = max_active
        self.view_len = view_len
        self.block_size = block_size
        self.device = api.device

        tmpl = api.init_cache(1, view_len)
        self.paged = PagedKV({n: tmpl[n] for n in PAGED_LEAVES},
                             block_size=block_size, max_requests=max_active,
                             num_blocks=num_blocks)
        R = max_active
        self.lengths = torch.zeros((R,), dtype=torch.long, device=self.device)
        self.cur_tokens = torch.zeros((R,), dtype=torch.long,
                                      device=self.device)
        self._free_slots = list(range(R - 1, -1, -1))
        self._active_mask = np.zeros((R,), bool)
        self._slot_req: dict[int, object] = {}

    # -- request lifecycle -------------------------------------------------

    @torch.inference_mode()
    def admit(self, req) -> int:
        """Prefill ``req`` into a free slot; returns the slot. The first
        generated token comes from the prefill logits."""
        if not self._free_slots:
            raise RuntimeError("no free request slot")
        if req.prompt_len > self.view_len:
            raise ValueError(f"prompt {req.prompt_len} exceeds KV view "
                             f"{self.view_len}")
        slot = self._free_slots[-1]
        if not self.paged.admit(slot):
            raise RuntimeError("KV block pool exhausted")
        self._free_slots.pop()
        tokens = torch.tensor(np.asarray(req.prompt, np.int64),
                              device=self.device)[None]
        logits, cache = self.api.prefill(self.params, tokens, self.view_len)
        self.paged.write_view(slot, {n: cache[n] for n in PAGED_LEAVES})
        self.lengths[slot] = req.prompt_len
        self.cur_tokens[slot] = torch.argmax(logits[0, -1])
        self._active_mask[slot] = True
        self._slot_req[slot] = req
        return slot

    def release(self, slot: int) -> None:
        """Free a slot (retire or preempt): blocks back to the pool."""
        self.paged.release(slot)
        self._active_mask[slot] = False
        self._slot_req.pop(slot, None)
        self._free_slots.append(slot)

    @torch.inference_mode()
    def step(self):
        """One decode step for every active slot. Returns {slot: token}."""
        tables = self.paged.tables
        views = gather_views(self.paged.pools, tables, self.block_size)
        cache = {**views, "length": self.lengths}
        logits, nc = self.api.decode_step(self.params, cache,
                                          self.cur_tokens[:, None])
        scatter_tokens(self.paged.pools, tables,
                       {n: nc[n] for n in PAGED_LEAVES},
                       self.lengths % self.view_len, self.block_size)
        active = torch.from_numpy(self._active_mask).to(self.device)
        self.lengths = torch.where(active, nc["length"], self.lengths)
        next_tok = torch.argmax(logits, -1)
        self.cur_tokens = torch.where(active, next_tok, self.cur_tokens)
        toks = next_tok.cpu()            # sync point: honest token latency
        return {s: int(toks[s]) for s in range(self.max_active)
                if self._active_mask[s]}

    # -- serving loop ------------------------------------------------------

    def run(self, sched, *, cost_model: Optional[Callable] = None,
            max_steps: int = 100000) -> ServeResult:
        """Drive the scheduler to completion.

        ``cost_model(kind, n) -> seconds`` (kinds: ``"prefill"`` with the
        prompt length, ``"decode"`` with the active count) switches the
        run to deterministic simulated time; otherwise wall clock.
        """
        sim = cost_model is not None
        wall0 = time.perf_counter()
        now = 0.0 if sim else time.perf_counter()

        def idle_until(t):
            nonlocal now
            if sim:
                now = max(now, t)
            else:
                wait = t - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                now = time.perf_counter()

        if not sim:
            # express trace arrivals relative to run start
            base = now
            for r in list(sched.pending):
                r.arrival_s += base

        steps = 0
        while not sched.done and steps < max_steps:
            steps += 1
            if not sched.active:
                nxt = sched.next_arrival()
                if nxt is not None and nxt > now:
                    idle_until(nxt)
            for req in sched.admissible(now):
                t0 = now if sim else time.perf_counter()
                slot = self.admit(req)
                # first token is produced by the prefill itself (and
                # reading it waits for the prefill to finish)
                tok0 = int(self.cur_tokens[slot].cpu())
                if sim:
                    now += cost_model("prefill", req.prompt_len)
                    dur_ms = 1e3 * cost_model("prefill", req.prompt_len)
                else:
                    now = time.perf_counter()
                    dur_ms = 1e3 * (now - t0)
                sched.start(req, now, slot)
                sched.note_prefill(dur_ms)
                sched.record_token(req, tok0, now)
            if sched.active:
                toks = self.step()
                if sim:
                    now += cost_model("decode", len(toks))
                else:
                    now = time.perf_counter()
                for slot, tok in toks.items():
                    req = self._slot_req.get(slot)
                    if req is not None and len(req.generated) < req.max_new:
                        sched.record_token(req, tok, now)
                sched.note_decode(now)
            for req in sched.retire_done(now):
                self.release(req.slot)

        if not sched.done:
            raise RuntimeError(f"serving loop hit max_steps={max_steps}")
        summary = sched.latency_summary()
        return ServeResult(
            summary=summary,
            records=[r.record() for r in
                     sorted(sched.finished, key=lambda r: r.rid)],
            wall_s=time.perf_counter() - wall0)
