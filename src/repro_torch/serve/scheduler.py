"""Continuous-batching scheduler: arrivals, admission, SLO-aware interleave.

Pure host-side policy, numpy only: a copy of ``repro.serve.scheduler``.
The engine owns device resources (KV blocks, request slots) and drives
the loop; the scheduler decides *which* requests join each step, under
three constraints:

  * slot bound   — at most ``max_active`` requests in flight (the engine's
                   fixed batch width);
  * token budget — sum over active requests of ``prompt + max_new`` tokens
                   may not exceed ``token_budget`` (KV memory proxy);
  * latency SLO  — a prefill stalls every in-flight decode for roughly one
                   prefill duration, so when decodes are already close to
                   the per-token SLO, admission is deferred until the gap
                   clears (classic continuous-batching head-of-line rule).

Requests join mid-flight as they arrive and retire individually the step
their ``max_new``-th token lands — the fixed batch never drains to refill.

The clock is injected everywhere (``now`` arguments), so the same policy
runs under a wall clock in ``launch/serve.py`` and under a deterministic
simulated clock in the benchmark and tests.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One serving request, plus its lifecycle record.

    The timestamp fields are filled in by the scheduler/engine as the
    request moves queue -> prefill -> decode -> retired; they become the
    per-request spans exported to ``decode_summary.json``.
    """
    rid: int
    arrival_s: float
    prompt: tuple
    max_new: int
    # lifecycle (filled during serving)
    slot: Optional[int] = None
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    token_s: list = dataclasses.field(default_factory=list)
    generated: list = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def budget_tokens(self) -> int:
        return self.prompt_len + self.max_new

    def record(self) -> dict:
        """Per-request span for decode_summary.json."""
        gaps = [1e3 * (b - a) for a, b in zip(self.token_s, self.token_s[1:])]
        return {
            "rid": self.rid,
            "arrival_s": round(self.arrival_s, 6),
            "admit_s": round(self.admit_s, 6),
            "first_token_s": round(self.first_token_s, 6),
            "finish_s": round(self.finish_s, 6),
            "prompt_len": self.prompt_len,
            "new_tokens": len(self.generated),
            "queue_ms": round(1e3 * (self.admit_s - self.arrival_s), 3),
            "ttft_ms": round(1e3 * (self.first_token_s - self.arrival_s), 3),
            "token_ms_max": round(max(gaps), 3) if gaps else 0.0,
        }


def synthetic_trace(num_requests: int, *, rate_rps: float, vocab: int,
                    prompt_lens=(8, 16, 32), max_new: int = 16,
                    seed: int = 0):
    """Poisson arrivals with mixed prompt lengths (the benchmark trace)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=num_requests)
    arrivals = np.cumsum(gaps) - gaps[0]          # first request at t=0
    out = []
    for i, t in enumerate(arrivals):
        plen = int(rng.choice(prompt_lens))
        prompt = tuple(int(x) for x in rng.integers(0, vocab, size=plen))
        out.append(Request(rid=i, arrival_s=float(t), prompt=prompt,
                           max_new=max_new))
    return out


def load_trace(path: str, *, vocab: int, seed: int = 0):
    """Read a JSONL request trace: {"arrival_s", "prompt_len"|"prompt",
    "max_new"} per line. Prompts given only by length are filled with
    seeded random token ids."""
    rng = np.random.default_rng(seed)
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "prompt" in d:
                prompt = tuple(int(x) for x in d["prompt"])
            else:
                prompt = tuple(
                    int(x) for x in
                    rng.integers(0, vocab, size=int(d["prompt_len"])))
            out.append(Request(rid=i, arrival_s=float(d["arrival_s"]),
                               prompt=prompt,
                               max_new=int(d.get("max_new", 16))))
    return out


class Scheduler:
    """Continuous-batching admission/retire policy over a request trace."""

    def __init__(self, trace, *, max_active: int, token_budget: int,
                 slo_ms: Optional[float] = None, drain: bool = False):
        self.pending = deque(sorted(trace, key=lambda r: r.arrival_s))
        self.active: dict[int, Request] = {}
        self.finished: list[Request] = []
        self.max_active = max_active
        self.token_budget = token_budget
        self.slo_ms = slo_ms
        # drain=True: the fixed-batch baseline — refill only once the whole
        # batch has retired (no mid-flight joins), the policy continuous
        # batching exists to beat
        self.drain = drain
        self._last_decode_s: Optional[float] = None
        self._prefill_ms_ema: float = 0.0

    # -- engine feedback ---------------------------------------------------

    def note_decode(self, now: float) -> None:
        """The engine finished a decode step at ``now``."""
        self._last_decode_s = now

    def note_prefill(self, ms: float) -> None:
        """The engine finished a prefill that took ``ms`` milliseconds."""
        a = 0.5
        self._prefill_ms_ema = (a * ms + (1 - a) * self._prefill_ms_ema
                                if self._prefill_ms_ema else ms)

    # -- policy ------------------------------------------------------------

    def _active_budget(self) -> int:
        return self.token_budget - sum(r.budget_tokens
                                       for r in self.active.values())

    def _prefill_would_bust_slo(self, now: float) -> bool:
        if not (self.slo_ms and self.active and
                self._last_decode_s is not None):
            return False
        gap_ms = 1e3 * (now - self._last_decode_s)
        return gap_ms + self._prefill_ms_ema > self.slo_ms

    def admissible(self, now: float):
        """Arrived requests to prefill-and-join this step, in order."""
        if self.drain and self.active:
            return []
        out = []
        budget = self._active_budget()
        while self.pending and self.pending[0].arrival_s <= now:
            r = self.pending[0]
            if len(self.active) + len(out) >= self.max_active:
                break
            if r.budget_tokens > budget:
                break
            if self._prefill_would_bust_slo(now):
                break
            budget -= r.budget_tokens
            out.append(self.pending.popleft())
        return out

    def start(self, req: Request, now: float, slot: int) -> None:
        req.slot = slot
        req.admit_s = now
        self.active[req.rid] = req

    def record_token(self, req: Request, token: int, now: float) -> None:
        if req.first_token_s is None:
            req.first_token_s = now
        req.token_s.append(now)
        req.generated.append(int(token))

    def retire_done(self, now: float):
        """Retire every active request that has its last token; returns
        the retired requests (the engine frees their blocks)."""
        done = [r for r in self.active.values()
                if len(r.generated) >= r.max_new]
        for r in done:
            r.finish_s = now
            del self.active[r.rid]
            self.finished.append(r)
        return done

    def preempt(self, rid: int) -> Request:
        """Pull an active request back to the head of the queue (its blocks
        go back to the pool; it will re-prefill prompt+generated on
        re-admission). vLLM-style recompute preemption."""
        r = self.active.pop(rid)
        r.prompt = tuple(r.prompt) + tuple(r.generated)
        r.max_new -= len(r.generated)
        r.generated = []
        r.slot = None
        self.pending.appendleft(r)
        return r

    @property
    def done(self) -> bool:
        return not self.pending and not self.active

    def next_arrival(self) -> Optional[float]:
        return self.pending[0].arrival_s if self.pending else None

    # -- reporting ---------------------------------------------------------

    def latency_summary(self):
        """Inter-token latency percentiles (ms) + throughput over the run."""
        gaps = []
        for r in self.finished:
            ts = ([r.admit_s] + r.token_s) if r.token_s else []
            gaps.extend(1e3 * (b - a) for a, b in zip(ts, ts[1:]))
        toks = sum(len(r.generated) for r in self.finished)
        t0 = min((r.arrival_s for r in self.finished), default=0.0)
        t1 = max((r.finish_s for r in self.finished), default=0.0)
        span = max(t1 - t0, 1e-9)
        pct = (lambda q: float(np.percentile(gaps, q)) if gaps else 0.0)
        return {
            "requests": len(self.finished),
            "new_tokens": toks,
            "tok_per_s": toks / span,
            "token_ms_p50": pct(50),
            "token_ms_p90": pct(90),
            "token_ms_p99": pct(99),
        }
