"""Serving engine: batched decode over paged KV (port of ``repro/serve/engine.py``).

Execution model
---------------
The engine owns ``max_active`` fixed request *slots*. The family cache
from ``api.init_cache(batch=1, view_len)`` is split, as in the
reference, into:

  * paged leaves — the top-level attention ``k``/``v`` tensors, where the
    family has them, stored in a :class:`~repro_torch.serve.paged_kv.PagedKV`
    block pool (the SSM family has none: ``self.paged`` is ``None``);
  * opaque per-request state — every other leaf, nested dicts included
    (the SSM conv/ssd state, the enc-dec family's cross KV ``xk``/``xv``),
    one batched tensor per leaf with the slot on axis 1, after the layer
    axis, where every family's cache keeps its batch;
  * lengths — one engine-owned ``(max_active,)`` vector, passed as the
    cache's ``length`` where the template has one.

The reference vmaps a batch-1 ``decode_step`` over the slots, each on
a dense view gathered through its block table, and scatters the new
token back into the pool. Here one step runs ONE batched
``decode_step`` over every slot with the per-slot lengths and opaque
state and the paged cache itself (``k_pool``/``v_pool``, the int32
block tables, ``length``): in every attention layer the slot's token is
written IN PLACE into its ring slot ``length % view_len`` of the pool,
and ``ops.paged_attention`` (``attn_impl``: ``"auto"`` runs the
hand-written kernel on the card, ``"xla"`` the gather path) reads the
pool through the tables, that token included, with no dense view in
between. The step then keeps the new opaque state of the active slots
and argmaxes the next token. Inactive slots read and write the null
block and keep their length and state.

A slot's row of the batched step depends only on its own data: the
attention rows are independent, and the MoE family routes each row as
its own group (per-row expert capacity, as the reference's vmap of
batch-1 decodes does; its fixed-batch decode keeps the batched
capacity). So for the dense, SSM and hybrid families the paged engine
gives exactly the tokens of the same batched decode over dense caches
(the tests' oracle; on the CPU the paged attention is the gather path,
bit for bit the dense one).

Opaque state is written at admit in the store's dtype (as the
reference's ``.at[slot].set`` casts), and after each step the store
takes ``decode_step``'s output dtype, as the reference's
``self.opaque = new_opq`` does: at fp32 compute the bf16 conv history
of the template becomes fp32 after the first step in both.

``prefill_extra(req)`` gives a request's inputs beyond its prompt,
passed to ``api.prefill`` at admit (the enc-dec family's ``audio``; its
cross KV then rides as opaque state, which a step returns unchanged and
the engine keeps without a copy).

Timing is injected: with ``cost_model=None`` the run loop uses the wall
clock; a ``cost_model(kind, n) -> seconds`` callable switches every
duration (and the arrival clock) to deterministic simulated time.

Tensor-parallel decode. With a ``mesh`` and a `Communicator` (``comm``)
every rank of the mesh's ``axis`` runs an engine over the same params
and trace, the model compute replicated, and each decode step's logits
are reassembled through the tuned ``collective`` from each rank's own
V/p columns (`launch.tp_decode.assemble_logits`, built from the same
requests ``Communicator.explain`` renders, so the reported decode plan
is exactly the executed plan): bit-identical to the one-process decode.
Decode logits at serving batch sizes are KB-scale messages, the
small-message end of the tuning grid. Every rank must then run the same
steps in the same order, or the logits collective hangs; but admission
reads a clock (arrivals against the wall clock, the SLO guard's gap
since the last decode and its prefill EMA) that differs between
processes. So rank 0 of the axis decides: each iteration of `run` it
reads the clock, takes the scheduler's admissions, and broadcasts the
clock value and the admitted requests over the axis, and the other
ranks admit exactly those (retirement follows from the tokens, equal
on every rank). That is one extra host round (a ``gloo`` broadcast) a
step. ``decisions`` keeps each iteration's (clock, admitted ids) as
every rank applied them, ``executed`` the logits collectives run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.collectives import group as grp
from repro_torch.serve.paged_kv import PagedKV

PAGED_LEAVES = ("k", "v")


def _map(tree, fn, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts), zipped with the
    same-shaped ``rest`` trees."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _rows(mask, leaf):
    """``(R,)`` mask broadcast over a leaf whose slot axis is axis 1."""
    return mask.view((1, -1) + (1,) * (leaf.dim() - 2))


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
                 num_blocks: Optional[int] = None, attn_impl: str = "auto",
                 mesh=None, comm=None, collective: str = "all_gather",
                 axis: str = "model",
                 prefill_extra: Optional[Callable] = None):
        self.api = api
        self.attn_impl = attn_impl
        self.params = params
        self.max_active = max_active
        self.view_len = view_len
        self.block_size = block_size
        self.device = api.device
        # per-request inputs beyond the token prompt (encdec: audio)
        self.prefill_extra = prefill_extra or (lambda req: {})

        tmpl = api.init_cache(1, view_len)
        self._has_length = "length" in tmpl
        paged_tmpl = {n: tmpl[n] for n in PAGED_LEAVES if n in tmpl}
        self.paged_names = tuple(paged_tmpl)
        self.paged = PagedKV(paged_tmpl, block_size=block_size,
                             max_requests=max_active,
                             num_blocks=num_blocks) if paged_tmpl else None
        R = max_active
        self.opaque = _map(
            {n: v for n, v in tmpl.items()
             if n not in self.paged_names and n != "length"},
            lambda a: a.new_zeros((a.shape[0], R) + tuple(a.shape[2:])))
        self.lengths = torch.zeros((R,), dtype=torch.long, device=self.device)
        self.cur_tokens = torch.zeros((R,), dtype=torch.long,
                                      device=self.device)
        self._free_slots = list(range(R - 1, -1, -1))
        self._active_mask = np.zeros((R,), bool)
        self._slot_req: dict[int, object] = {}
        self.decode_steps = 0               # batched decode steps run

        self._mesh = mesh
        self._comm = comm
        self._collective = collective
        self._axis = axis
        self._tp = mesh.shape[axis] if (mesh is not None and
                                        comm is not None) else 0
        self.decisions: list = []           # (clock, admitted rids) a step
        self.executed: set = set()          # (nbytes, algorithm, segments)

    # -- tuned decode plan -------------------------------------------------

    def decode_requests(self):
        """The decode-step collective requests (for ``explain()``) — same
        builders as the executed step, batch = the slot count."""
        from repro_torch.launch.tp_decode import decode_requests
        cfg = self.api.cfg
        return decode_requests(self.max_active, cfg.d_model, cfg.vocab_size,
                               max(self._tp, 2), axis=self._axis)

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
        if self.paged is not None and not self.paged.admit(slot):
            raise RuntimeError("KV block pool exhausted")
        self._free_slots.pop()
        tokens = torch.tensor(np.asarray(req.prompt, np.int64),
                              device=self.device)[None]
        logits, cache = self.api.prefill(self.params, tokens, self.view_len,
                                         **self.prefill_extra(req))
        if self.paged is not None:
            self.paged.write_view(slot, {n: cache[n]
                                         for n in self.paged_names})

        def put(store, leaf):               # casts to the store's dtype
            store[:, slot] = leaf[:, 0]
        _map(self.opaque, put, {n: cache[n] for n in self.opaque})
        self.lengths[slot] = req.prompt_len
        self.cur_tokens[slot] = torch.argmax(logits[0, -1])
        self._active_mask[slot] = True
        self._slot_req[slot] = req
        return slot

    def release(self, slot: int) -> None:
        """Free a slot (retire or preempt): blocks back to the pool."""
        if self.paged is not None:
            self.paged.release(slot)
        self._active_mask[slot] = False
        self._slot_req.pop(slot, None)
        self._free_slots.append(slot)

    @torch.inference_mode()
    def step(self):
        """One decode step for every active slot. Returns {slot: token}."""
        cache = dict(self.opaque)
        kw = {}
        if self.paged is not None:
            cache.update({f"{n}_pool": pool
                          for n, pool in self.paged.pools.items()})
            cache["block_tables"] = self.paged.tables
            kw["attn_impl"] = self.attn_impl
        if self._has_length:
            cache["length"] = self.lengths
        logits, nc = self.api.decode_step(self.params, cache,
                                          self.cur_tokens[:, None], **kw)
        if self._tp:
            from repro_torch.launch.tp_decode import assemble_logits
            logits = assemble_logits(logits, self._mesh, self._comm,
                                     collective=self._collective,
                                     axis=self._axis,
                                     executed=self.executed)
        self.decode_steps += 1
        active = torch.from_numpy(self._active_mask).to(self.device)
        # a leaf the step passed through unchanged (the enc-dec cross KV)
        # is kept as it is, not copied
        self.opaque = _map(
            self.opaque, lambda old, new: old if new is old else torch.where(
                _rows(active, new), new, old),
            {n: nc[n] for n in self.opaque})
        new_len = nc["length"] if self._has_length else self.lengths + 1
        self.lengths = torch.where(active, new_len, self.lengths)
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
        ax = self._mesh.axis(self._axis) if self._tp else None
        lead = ax is None or grp.rank(ax) == 0
        if ax is not None:              # one clock: rank 0's
            now = grp.broadcast_object(now, ax)

        def idle_until(t):
            nonlocal now
            if sim:
                now = max(now, t)
            elif lead:                  # the others wait in the broadcast
                wait = t - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                now = time.perf_counter()

        def admissions():
            """This iteration's admitted requests: the scheduler's, or,
            under tensor parallelism, rank 0's decision (clock value and
            request ids), broadcast over the axis and applied."""
            nonlocal now
            if ax is None:
                return sched.admissible(now)
            if lead:
                reqs = sched.admissible(now)
                now, rids = grp.broadcast_object(
                    (now, [r.rid for r in reqs]), ax)
            else:
                now, rids = grp.broadcast_object(None, ax)
                reqs = [sched.pending.popleft() for _ in rids]
                if [r.rid for r in reqs] != rids:
                    raise RuntimeError(f"rank 0 admitted {rids}; this "
                                       f"rank's queue holds "
                                       f"{[r.rid for r in reqs]}")
            self.decisions.append((now, rids))
            return reqs

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
            for req in admissions():
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
