"""Schedule synthesis for collectives at concrete fan-outs (survey §6).

A copy of ``repro/core/collectives/synth.py`` (numpy search over
programs, the registry and ``runner``). One change: a front entry is
priced by ``program_cost``, the number the reference's
``hierarchy.modeled_phase_cost`` closure returns for a pinned
``synth:`` method, since ``core/analytical/hierarchy.py`` is not ported
yet. The reference's text follows.

SCCL-style synthesis reduced to the rotation-symmetric step-program IR
of ``program.py``: for a concrete fan-out ``p`` we enumerate the k-step
schedule families expressible in the IR for all_reduce /
reduce_scatter / all_gather, *verify* each candidate with the symbolic
contribution-set checker, price the survivors on the SAME
``core/analytical/hierarchy.py`` cost closure the tuners and telemetry
residuals use, and keep the latency (step count) vs bandwidth (wire
chunks) pareto front.

Families (all derived from the dissemination schedule, which is the
unique no-waste generalization of Bruck to arbitrary ``p``):

  * ``dissem`` all_gather, any p: ceil(log2 p) steps, p-1 chunk wire —
    simultaneously latency- and bandwidth-optimal, so the AG front is a
    single program.
  * ``dissem`` reduce_scatter, any p: the time-reversal dual of the AG
    program (steps reversed, direction negated, offsets remapped,
    copies become reduces).
  * ``rsag`` all_reduce, any p: RS dual then AG — 2*ceil(log2 p) steps,
    2(p-1) chunk wire (Rabenseifner-shaped, but valid at any fan-out).
  * ``dissem`` all_reduce, p = 2^k only: k full-buffer reduce steps at
    doubling rotation distance — latency-optimal, k*p chunk wire.
    (Disjointness of the contribution runs forces a power of two; the
    verifier rejects every other fan-out.)
  * ``hybrid<l>`` all_reduce, p = 2^k, 0 < l < k: l partial
    reduce-scatter steps over residue-class chunk blocks, a (k-l)-step
    dissemination over the stride-2^l class, then l allgather copy
    steps back — k+l steps, 2p(1-2^-l) + (k-l)p/2^l chunk wire.  The
    l = k-1 member has rabenseifner's wire with one fewer step, so it
    strictly dominates it on the analytical model.

Verified programs register here; ``core/tuning/space.methods_for``
offers ``synth:<name>`` candidates for registered (op, p) so all the
survey tuners pick between hand-written and synthesized schedules on
equal footing, and ``algorithms.get`` dispatches them by materializing
the family at the call-time fan-out (names are family-parametric, so a
nearest-on-grid table decision still executes at off-grid fan-outs).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.analytical.base import CommModel, DEFAULT_HOCKNEY, VPU_GAMMA
from repro_torch.core.collectives.program import (
    PROGRAM_OPS, Program, ProgramError, Step, make_runner, validate)

SYNTH_PREFIX = "synth:"

# (op, p) -> {name: Program}; every entry has passed `validate`.
_REGISTRY: Dict[Tuple[str, int], Dict[str, Program]] = {}
# (op, p) -> tuple of names on the pareto front (what tuners are offered).
_FRONTS: Dict[Tuple[str, int], Tuple[str, ...]] = {}


def _is_pow2(p: int) -> bool:
    return p >= 2 and (p & (p - 1)) == 0


# ===========================================================================
# Family generators
# ===========================================================================
def _dissem_rounds(p: int) -> List[Tuple[int, int]]:
    """Generalized-Bruck round plan: [(distance, blocks_sent)]."""
    rounds, d = [], 1
    while d < p:
        nb = min(d, p - d)
        rounds.append((d, nb))
        d += nb
    return rounds


def _ag_dissem(p: int) -> Program:
    steps = tuple(Step(shift=p - d, offsets=tuple(range(nb)))
                  for d, nb in _dissem_rounds(p))
    return Program("all_gather", p, steps, "dissem")


def _rs_dual(ag: Program) -> Tuple[Step, ...]:
    """Time-reversal dual: reverse steps, flip direction, remap offsets,
    copies become reduces.  An AG step moving chunk c from rank s to
    rank s+shift becomes an RS step moving the partial of chunk c back
    from s+shift to s for combining."""
    p = ag.p
    steps = []
    for st in reversed(ag.steps):
        sh = st.shift % p
        steps.append(Step(shift=(p - sh) % p,
                          offsets=tuple(sorted((o - sh) % p
                                               for o in st.offsets)),
                          reduce=True))
    return tuple(steps)


def _rs_dissem(p: int) -> Program:
    return Program("reduce_scatter", p, _rs_dual(_ag_dissem(p)), "dissem")


def _ar_rsag(p: int) -> Program:
    ag = _ag_dissem(p)
    return Program("all_reduce", p, _rs_dual(ag) + ag.steps, "rsag")


def _ar_dissem(p: int) -> Program:
    steps = tuple(Step(shift=1 << s, offsets=tuple(range(p)), reduce=True)
                  for s in range(p.bit_length() - 1))
    return Program("all_reduce", p, steps, "dissem")


def _ar_hybrid(p: int, l: int) -> Program:
    """Partial RS (l halvings over residue classes) + dissemination over
    the stride-2^l class + partial AG back."""
    k = p.bit_length() - 1
    rs = tuple(Step(shift=p - (1 << j),
                    offsets=tuple(o for o in range(p)
                                  if o % (1 << (j + 1)) == (1 << j)),
                    reduce=True)
               for j in range(l))
    mid = tuple(Step(shift=(1 << l) << i,
                     offsets=tuple(o for o in range(p)
                                   if o % (1 << l) == 0),
                     reduce=True)
                for i in range(k - l))
    ag = tuple(Step(shift=1 << j,
                    offsets=tuple(o for o in range(p)
                                  if o % (1 << (j + 1)) == 0))
               for j in reversed(range(l)))
    return Program("all_reduce", p, rs + mid + ag, f"hybrid{l}")


def families(op: str, p: int) -> Dict[str, Program]:
    """Every IR-expressible family at this (op, p), un-verified."""
    if op == "all_gather":
        return {"dissem": _ag_dissem(p)}
    if op == "reduce_scatter":
        return {"dissem": _rs_dissem(p)}
    if op == "all_reduce":
        out = {"rsag": _ar_rsag(p)}
        if _is_pow2(p):
            out["dissem"] = _ar_dissem(p)
            k = p.bit_length() - 1
            for l in range(1, k):
                out[f"hybrid{l}"] = _ar_hybrid(p, l)
        return out
    raise KeyError(f"no synthesis families for op {op!r} "
                   f"(have {PROGRAM_OPS})")


# ===========================================================================
# Registry / materialization
# ===========================================================================
def register_program(prog: Program) -> Program:
    """Validate and register; rejects invalid programs with the
    verifier's actionable error."""
    validate(prog)
    _REGISTRY.setdefault((prog.op, prog.p), {})[prog.name] = prog
    return prog


def get_program(op: str, name: str, p: int) -> Program:
    """Registered program, materializing the named family on demand so
    nearest-on-grid table decisions still dispatch at off-grid
    fan-outs."""
    progs = _REGISTRY.get((op, p), {})
    if name in progs:
        return progs[name]
    fams = families(op, p)
    if name not in fams:
        raise KeyError(
            f"synth:{name} is not synthesizable for {op} at p={p}"
            + (" (family requires a power-of-two fan-out)"
               if not _is_pow2(p) else "")
            + f"; available families: {sorted(fams)}")
    return register_program(fams[name])


def registered(op: str, p: int) -> Tuple[str, ...]:
    """Pareto-front names offered to the tuning grid for (op, p)."""
    return _FRONTS.get((op, p), ())


def clear_registry() -> None:
    """Test hook: forget all registered programs and fronts."""
    _REGISTRY.clear()
    _FRONTS.clear()


def _dispatch_program(op: str, name: str, p: int) -> Program:
    """`get_program`, degraded for execution: a nearest-on-grid table
    decision can name a family that does not exist at the call-time
    fan-out (e.g. ``hybrid1`` tuned at p=4, dispatched at p=2) — fall
    back to the any-p family for the op rather than fail inside
    the ranks' program.  Direct `get_program` callers keep the strict error."""
    try:
        return get_program(op, name, p)
    except KeyError:
        return get_program(op, "rsag" if op == "all_reduce" else "dissem", p)


def runner(op: str, name: str):
    """``algorithms.py``-style callable dispatching ``synth:<name>`` —
    materializes the family at the call-time ``axis_size`` (at
    axis_size 1 every program op is the identity)."""
    if op in ("all_reduce", "reduce_scatter"):
        def fn(x, axis, axis_size, *, op="add", segments=1, _coll=op):
            if axis_size == 1:
                return x
            return make_runner(_dispatch_program(_coll, name, axis_size))(
                x, axis, axis_size, op=op, segments=segments)
    elif op == "all_gather":
        def fn(x, axis, axis_size, *, segments=1):
            if axis_size == 1:
                return x
            return make_runner(_dispatch_program("all_gather", name,
                                                 axis_size))(
                x, axis, axis_size, segments=segments)
    else:
        raise KeyError(f"no synthesized algorithms for op {op!r}")
    fn.__name__ = f"synth_{op}_{name}"
    return fn


# ===========================================================================
# Pricing (through the same closure as tuners / residuals)
# ===========================================================================
def program_cost(op: str, name: str, model: CommModel, p: int, m: float,
                 *, gamma: float = VPU_GAMMA) -> float:
    """alpha-beta-gamma cost of a synthesized program — the `costs.py`
    branch for ``synth:`` algorithms.  all_gather follows the repo
    convention that ``m`` is the per-rank shard (chunk) size; reduce
    ops chunk the full local buffer into p rows.  Prices the same
    program dispatch would execute at this fan-out (incl. the
    off-family fallback)."""
    prog = _dispatch_program(op, name, p)
    cb = m if op == "all_gather" else m / p
    total = 0.0
    for st in prog.steps:
        nb = st.wire_chunks * cb
        total += model.p2p(nb)
        if st.reduce:
            total += gamma * nb
    return total


def rounds_for(op: str, name: str, p: int, m: float
               ) -> List[Tuple[float, float, float]]:
    """Per-step (bytes_on_wire, contention, combine_bytes) rows for the
    packet-level `tuning/simulator.py`."""
    prog = _dispatch_program(op, name, p)
    cb = m if op == "all_gather" else m / p
    return [(st.wire_chunks * cb, 1.0,
             st.wire_chunks * cb if st.reduce else 0.0)
            for st in prog.steps]


# ===========================================================================
# Synthesis entry point
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class FrontEntry:
    program: Program
    n_steps: int
    wire_chunks: int
    reduce_chunks: int
    cost: float            # closure-priced seconds at `nbytes`


def synthesize_front(op: str, p: int, *,
                     model: CommModel = DEFAULT_HOCKNEY,
                     nbytes: float = 1 << 20,
                     gamma: float = VPU_GAMMA,
                     register: bool = True) -> List[FrontEntry]:
    """Enumerate, verify, price, and pareto-filter the families at
    (op, p).

    Pricing is ``program_cost``: the reference prices through
    ``hierarchy.modeled_phase_cost`` with the candidate pinned as the
    level method, and with a pinned ``synth:`` method that closure
    reduces to ``collective_cost`` -> ``program_cost``, so this gives the
    reference's number without the hierarchy module (not ported yet).
    The front is non-dominated in
    (steps, wire chunks, combine chunks); the closure's cost is a
    positive combination of exactly those three axes, so front
    membership is "best somewhere" over (message size, gamma).
    """
    verified: Dict[str, Program] = {}
    for name, prog in sorted(families(op, p).items()):
        try:
            verified[name] = validate(prog)
        except ProgramError:
            # a family whose structural precondition fails at this p
            # (e.g. dissem disjointness off powers of two) is skipped
            continue

    # verifier-approved candidates must be visible to the pricing
    # closure (collective_cost resolves synth: through the registry)
    for prog in verified.values():
        _REGISTRY.setdefault((op, p), {})[prog.name] = prog

    entries = []
    for name, prog in verified.items():
        cost = program_cost(op, name, model, p, float(nbytes), gamma=gamma)
        entries.append(FrontEntry(prog, prog.n_steps, prog.wire_chunks,
                                  prog.reduce_chunks, cost))

    def dominates(o, e):
        return (o.n_steps <= e.n_steps
                and o.wire_chunks <= e.wire_chunks
                and o.reduce_chunks <= e.reduce_chunks
                and (o.n_steps, o.wire_chunks, o.reduce_chunks)
                != (e.n_steps, e.wire_chunks, e.reduce_chunks))

    front = [e for e in entries
             if not any(dominates(o, e) for o in entries)]
    front.sort(key=lambda e: (e.n_steps, e.wire_chunks))
    if register:
        _FRONTS[(op, p)] = tuple(e.program.name for e in front)
    return front


def synthesize_all(ops, ps, *, model: CommModel = DEFAULT_HOCKNEY,
                   gamma: float = VPU_GAMMA) -> Dict[Tuple[str, int], Tuple[str, ...]]:
    """Register pareto fronts for every (op, p) in the cross product;
    ops outside PROGRAM_OPS are skipped (no synthesis families)."""
    out = {}
    for op in ops:
        if op not in PROGRAM_OPS:
            continue
        for p in ps:
            front = synthesize_front(op, p, model=model, gamma=gamma)
            out[(op, p)] = tuple(e.program.name for e in front)
    return out


# ===========================================================================
# Artifact persistence (TableMeta.programs)
# ===========================================================================
def programs_to_json(ops, ps) -> Optional[List[dict]]:
    """Serialized front programs covering (ops x ps) — the value stamped
    into ``TableMeta.programs``; None when nothing is registered (so
    artifacts without synthesis stay byte-identical to today's)."""
    out = []
    for op in ops:
        for p in ps:
            for name in _FRONTS.get((op, p), ()):
                out.append(_REGISTRY[(op, p)][name].to_json())
    return out or None


def adopt_programs(programs_json) -> int:
    """Re-register artifact-carried programs at load (Communicator
    rebuild path).  Every program re-passes the verifier; front
    membership is restored so `methods_for`/explain see them.  Returns
    the number adopted."""
    n = 0
    for d in programs_json or ():
        prog = register_program(Program.from_json(d))
        key = (prog.op, prog.p)
        if prog.name not in _FRONTS.get(key, ()):
            _FRONTS[key] = _FRONTS.get(key, ()) + (prog.name,)
        n += 1
    return n
