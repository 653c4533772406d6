"""Step-program IR for synthesized collectives (SCCL-style, survey §6).

Port of ``repro/core/collectives/program.py``: the IR and the verifier
are the reference's; the interpreter runs inside each rank of a process
group, exchanging the gathered rows through ``group.ppermute`` and
reducing through ``algorithms._combine`` (the ``segment_combine``
kernel on the card). The reference's text follows.

A *program* is an explicit k-step schedule for one collective at one
concrete fan-out ``p``.  Each step is rotation-symmetric: every rank
``r`` sends the chunk rows ``{(r + o) % p : o in offsets}`` of its
``(p, chunk)`` working buffer to rank ``(r + shift) % p`` in a single
``ppermute``, and the receiver either reduce-combines or overwrites the
same *global* chunk indices — chunks keep their identity as they move,
so a step is fully described by ``(shift, offsets, reduce)`` and lowers
to exactly one collective-permute in the HLO.

Working-buffer conventions match ``algorithms.py``:

  * ``all_reduce`` / ``reduce_scatter``: the local buffer is flattened,
    padded to a multiple of ``p`` and viewed as ``(p, chunk)``; chunk
    ``c`` of rank ``r`` initially holds rank ``r``'s contribution to
    global chunk ``c``.
  * ``all_gather``: the working buffer is ``(p, shard)`` with only row
    ``r`` populated (rank ``r``'s shard).

Correctness is established *symbolically* before a program may run:
``validate`` tracks, per (rank, chunk), the exact set of rank
contributions present (as bitmasks), rejects reduce steps that would
double-count a contribution and copy steps that send garbage, and
checks the per-op final-state predicate.  Every error names the
offending step / rank / chunk so synthesis bugs are actionable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core.collectives import group as grp
from repro_torch.core.collectives.algorithms import (
    _combine, _flatten_pad, _tiled, _unflatten)

PROGRAM_OPS = ("all_reduce", "reduce_scatter", "all_gather")


class ProgramError(ValueError):
    """A step program failed structural or symbolic validation."""


@dataclasses.dataclass(frozen=True)
class Step:
    """One ppermute round: rank r sends rows (r+o)%p to rank (r+shift)%p."""
    shift: int
    offsets: Tuple[int, ...]
    reduce: bool = False

    @property
    def wire_chunks(self) -> int:
        return len(self.offsets)


@dataclasses.dataclass(frozen=True)
class Program:
    op: str
    p: int
    steps: Tuple[Step, ...]
    name: str

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    @property
    def wire_chunks(self) -> int:
        """Chunk-rows crossing each rank's egress link over the program."""
        return sum(s.wire_chunks for s in self.steps)

    @property
    def reduce_chunks(self) -> int:
        """Chunk-rows combined on arrival (gamma traffic)."""
        return sum(s.wire_chunks for s in self.steps if s.reduce)

    # -- artifact serialization (mirrors TableMeta field style) ------------
    def to_json(self) -> dict:
        return {
            "op": self.op,
            "p": self.p,
            "name": self.name,
            "steps": [[s.shift, list(s.offsets), bool(s.reduce)]
                      for s in self.steps],
        }

    @staticmethod
    def from_json(d: dict) -> "Program":
        steps = tuple(Step(int(sh), tuple(int(o) for o in offs), bool(red))
                      for sh, offs, red in d["steps"])
        return Program(op=d["op"], p=int(d["p"]), steps=steps,
                       name=d["name"])


# ===========================================================================
# Symbolic verifier
# ===========================================================================
def _initial_state(op: str, p: int) -> List[List[int]]:
    """state[rank][chunk] = bitmask of rank contributions present."""
    if op in ("all_reduce", "reduce_scatter"):
        return [[1 << r for _ in range(p)] for r in range(p)]
    # all_gather: chunk c exists only at rank c (its shard); model the
    # shard itself as "contribution of rank c".
    return [[(1 << c) if c == r else 0 for c in range(p)] for r in range(p)]


def validate(prog: Program) -> Program:
    """Symbolically execute ``prog``; raise ProgramError on any defect."""
    op, p = prog.op, prog.p
    if op not in PROGRAM_OPS:
        raise ProgramError(f"program {prog.name!r}: unsupported op {op!r} "
                           f"(have {PROGRAM_OPS})")
    if p < 2:
        raise ProgramError(f"program {prog.name!r}: fan-out p={p} < 2")
    if not prog.steps:
        raise ProgramError(f"program {prog.name!r} ({op}, p={p}): no steps")
    for i, st in enumerate(prog.steps):
        if st.shift % p == 0:
            raise ProgramError(
                f"program {prog.name!r} step {i}: shift {st.shift} is a "
                f"self-send (must be nonzero mod p={p})")
        if not st.offsets:
            raise ProgramError(
                f"program {prog.name!r} step {i}: empty offsets")
        offs = [o % p for o in st.offsets]
        if len(set(offs)) != len(offs):
            raise ProgramError(
                f"program {prog.name!r} step {i}: duplicate offsets "
                f"{st.offsets} mod p={p}")

    full = (1 << p) - 1
    state = _initial_state(op, p)
    for i, st in enumerate(prog.steps):
        d = st.shift % p
        new = [row[:] for row in state]
        for r in range(p):                      # r = receiver
            s = (r - d) % p                     # its sender
            for o in st.offsets:
                c = (s + o) % p                 # global chunk index
                incoming = state[s][c]
                if incoming == 0:
                    raise ProgramError(
                        f"program {prog.name!r} ({op}, p={p}) step {i}: "
                        f"rank {s} sends chunk {c} it does not hold "
                        f"(offset {o}) — non-covering send")
                if st.reduce:
                    if new[r][c] & incoming:
                        raise ProgramError(
                            f"program {prog.name!r} ({op}, p={p}) step {i}: "
                            f"reduce at rank {r} chunk {c} double-counts "
                            f"contribution(s) "
                            f"{sorted(b for b in range(p) if (new[r][c] & incoming) >> b & 1)}")
                    new[r][c] |= incoming
                else:
                    new[r][c] = incoming
        state = new

    # final-layout predicates
    if op == "all_reduce":
        for r in range(p):
            for c in range(p):
                if state[r][c] != full:
                    missing = [b for b in range(p)
                               if not (state[r][c] >> b) & 1]
                    raise ProgramError(
                        f"program {prog.name!r} (all_reduce, p={p}): final "
                        f"state at rank {r} chunk {c} is missing "
                        f"contributions from ranks {missing} — wrong final "
                        f"layout")
    elif op == "reduce_scatter":
        for r in range(p):
            if state[r][r] != full:
                missing = [b for b in range(p) if not (state[r][r] >> b) & 1]
                raise ProgramError(
                    f"program {prog.name!r} (reduce_scatter, p={p}): rank "
                    f"{r}'s own chunk {r} is missing contributions from "
                    f"ranks {missing} — wrong final layout")
    else:  # all_gather
        for r in range(p):
            for c in range(p):
                if state[r][c] != (1 << c):
                    raise ProgramError(
                        f"program {prog.name!r} (all_gather, p={p}): rank "
                        f"{r} chunk {c} holds mask {state[r][c]:#x}, want "
                        f"the shard of rank {c} — wrong final layout")
    return prog


# ===========================================================================
# Interpreter (runs inside each rank, same signature as algorithms.py)
# ===========================================================================
def _ascending_run(rows):
    """``rows`` as a slice where they are one ascending run of
    consecutive rows (a view of the buffer), else None (indexing with a
    list makes a copy, which an in-place combine would write into)."""
    if not rows or rows != list(range(rows[0], rows[0] + len(rows))):
        return None
    return slice(rows[0], rows[0] + len(rows))


def _run_steps(buf, r, prog: Program, axis, op_kind: str):
    p = prog.p
    for st in prog.steps:
        d = st.shift % p
        offs = [o % p for o in st.offsets]
        perm = [(i, (i + d) % p) for i in range(p)]
        send_rows = [(r + o) % p for o in offs]
        recv = grp.ppermute(buf[send_rows], perm, axis)
        recv_rows = [(r - d + o) % p for o in offs]
        run = _ascending_run(recv_rows)
        if st.reduce and run is not None:
            acc = buf[run]                     # a view: combined in place
            _combine(acc, recv, op_kind, out=acc)
        elif st.reduce:
            buf[recv_rows] = _combine(buf[recv_rows], recv, op_kind)
        else:
            buf[recv_rows] = recv
    return buf


def make_runner(prog: Program):
    """Wrap a validated program as an ``algorithms.py``-style callable.

    Programs are unsegmented schedules: ``segments`` is accepted for
    dispatch-signature compatibility and ignored.
    """
    if prog.op in ("all_reduce", "reduce_scatter"):
        def fn(x, axis, axis_size, *, op="add", segments=1):
            del segments
            p = prog.p
            assert axis_size == p, (
                f"program {prog.name!r} synthesized for p={p}, "
                f"dispatched at axis_size={axis_size}")
            r = grp.rank(axis)
            flat, shape, size = _flatten_pad(x, p)
            buf = _run_steps(flat.reshape(p, -1), r, prog, axis, op)
            if prog.op == "all_reduce":
                return _unflatten(buf.reshape(-1), shape, size)
            return buf[r]
    else:  # all_gather
        def fn(x, axis, axis_size, *, segments=1):
            del segments
            p = prog.p
            assert axis_size == p, (
                f"program {prog.name!r} synthesized for p={p}, "
                f"dispatched at axis_size={axis_size}")
            r = grp.rank(axis)
            m = x.numel()
            buf = torch.zeros((p, m), dtype=x.dtype, device=x.device)
            buf[r] = x.reshape(m)
            buf = _run_steps(buf, r, prog, axis, "add")
            return _tiled(buf, x)
    fn.__name__ = f"synth_{prog.op}_{prog.name}_p{prog.p}"
    fn.program = prog
    return fn
