"""Compile-free accounting of one rank's step (the port's counterpart of
``repro/launch/hlo_analysis.py``).

The reference lowers the step through XLA and reads the compiled
program: ``cost_analysis`` (FLOPs, bytes accessed), ``memory_analysis``
and, parsed from the optimized HLO, the bytes of every collective. The
port has no XLA: it runs one rank's step eagerly on ``meta`` tensors
(shapes and types, no storage) over a recording mesh
(``group.MetaMesh``), under `StepCounter`, a ``TorchDispatchMode`` that
sees every ATen operation the step issues, the backward and any
recompute included:

  * FLOPs: ``torch.utils.flop_counter``'s formulas for each operation
    it knows (products: ``mm``, ``bmm``, convolutions, attention), plus
    each hand-written kernel's own count, which its wrapper notes on
    ``meta`` (``repro_torch.count``; the same formula as the counter
    gives the kernel's plain reference, ``kernels/ref.py``);
  * bytes accessed: each operation's inputs plus its outputs (views and
    bare allocations move none), and each kernel's inputs read once and
    outputs written once. The port runs eagerly, so this is its real
    unfused traffic, where XLA counts after fusion;
  * live bytes: every storage the step makes is tracked until it is
    freed (autograd's saved tensors hold theirs), each rounded up to the
    caching allocator's 512 bytes, with the arguments (params, optimizer
    state, batch) live from the start: the peak, and the ten largest
    live tensors at it with the operation that made each;
  * collectives: the open ``group.Record``, which takes the place of the
    reference's HLO parser ``collective_bytes`` (there is no HLO):
    output bytes per rank by kind and axis.

`roofline` keeps the reference's fields and its ``dominant`` rule, over
the constants of an NVIDIA H100 SXM (data sheet, 700 W) in place of the
reference's v5e ones: 989e12 bf16 FLOP/s dense, 3.35e12 B/s of HBM,
450e9 B/s of NVLink each way (the reference's per-link ICI rate) and
80e9 B of HBM. `param_count` and `model_flops` are the reference's.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import count, pytree
from repro_torch.core.collectives import group as grp

#: NVIDIA H100 SXM, data sheet, 700 W
HARDWARE_NAME = "NVIDIA H100 SXM, data sheet, 700 W"
PEAK_FLOPS = 989e12          # bf16 FLOP/s, dense
HBM_BW = 3.35e12             # B/s
LINK_BW = 450e9              # B/s of NVLink, each way
HBM_BYTES = 80e9             # B
HARDWARE = {"name": HARDWARE_NAME, "peak_flops": PEAK_FLOPS,
            "hbm_bytes_per_s": HBM_BW, "link_bytes_per_s": LINK_BW,
            "hbm_bytes": HBM_BYTES}

#: the caching allocator's rounding of a block (``max_memory_allocated``
#: counts blocks)
ALLOC_ROUND = 512

_aten = torch.ops.aten
#: operations that move no bytes: bare allocations and metadata
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_like.default,
               _aten.empty_strided.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten._unsafe_view.default,
               _aten.lift_fresh.default, _aten.detach.default}


def _tensors(tree):
    return [t for t in pytree.leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts what the operations in its block do (see the module's
    text): ``flops``, ``bytes``, ``kernels`` (launches by kernel), the
    live bytes of storages on ``device`` (``peak_bytes``, `largest`) and
    ``record``, the collectives. `arguments` registers trees that exist
    before the block as live from its start."""

    def __init__(self, device="meta"):
        super().__init__()
        self.device = torch.device(device)
        self.flops = 0
        self.bytes = 0
        self.kernels: "collections.Counter" = collections.Counter()
        self.paused = 0
        self.record = grp.Record()
        self.live_bytes = self.peak_bytes = self.argument_bytes = 0
        self._live: dict = {}        # id(storage) -> allocation key
        self._allocs: list = []      # key -> (bytes, op, shape, dtype)
        self._events: list = []      # key (made) or ~key (freed)
        self._peak_at = 0
        self._finalizers: list = []

    # -- the count ----------------------------------------------------------
    def kernel(self, name: str, flops: int, nbytes: int,
               launches: int) -> None:
        self.flops += int(flops)
        self.bytes += int(nbytes)
        self.kernels[name] += launches

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused:
            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            if not func.is_view and func not in _NO_TRAFFIC:
                self.bytes += sum(_nbytes(t) for t in
                                  _tensors((args, kwargs)) + _tensors(out))
        for t in _tensors(out):
            self._track(t, str(func.overloadpacket).replace("aten.", ""))
        return out

    # -- live memory --------------------------------------------------------
    def arguments(self, tree) -> None:
        """Register the storages of ``tree`` as live from the start."""
        before = self.live_bytes
        for t in _tensors(tree):
            self._track(t, "argument")
        self.argument_bytes += self.live_bytes - before

    def _track(self, t: torch.Tensor, op: str) -> None:
        if t.device != self.device:
            return
        st = t.untyped_storage()
        sid = id(st)
        if sid in self._live:
            return
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        key = len(self._allocs)
        self._allocs.append((n, op, tuple(t.shape), str(t.dtype)
                             .replace("torch.", "")))
        self._live[sid] = key
        self.live_bytes += n
        self._events.append(key)
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self._peak_at = len(self._events)
        self._finalizers.append(weakref.finalize(st, self._free, sid, key))

    def _free(self, sid: int, key: int) -> None:
        if self._live.get(sid) == key:
            del self._live[sid]
        self.live_bytes -= self._allocs[key][0]
        self._events.append(~key)

    def _at_peak(self) -> set:
        live = set()
        for e in self._events[:self._peak_at]:
            if e >= 0:
                live.add(e)
            else:
                live.discard(~e)
        return live

    def largest(self, n: int = 10) -> list:
        """The ``n`` largest storages live at the peak: ``{"bytes", "op",
        "shape", "dtype"}`` each, largest first (``op`` is the operation
        that made it, or ``argument``)."""
        live = self._at_peak()
        keys = sorted(live, key=lambda k: -self._allocs[k][0])[:n]
        return [dict(zip(("bytes", "op", "shape", "dtype"),
                         (self._allocs[k][0], self._allocs[k][1],
                          list(self._allocs[k][2]), self._allocs[k][3])))
                for k in keys]

    def by_op(self, n: int = 10) -> list:
        """The live bytes at the peak summed by the operation that made
        them: ``[(op, bytes, storages)]``, largest first, ``n`` of them."""
        live = self._at_peak()
        sums: dict = {}
        for k in live:
            nbytes, op = self._allocs[k][:2]
            b, c = sums.get(op, (0, 0))
            sums[op] = (b + nbytes, c + 1)
        return sorted(((op, b, c) for op, (b, c) in sums.items()),
                      key=lambda x: -x[1])[:n]

    def output_bytes(self, tree) -> tuple:
        """``(output, alias)``: the bytes of the storages of ``tree`` (a
        step's results) and of those among them that are arguments
        (updated in place: the reference's donated buffers)."""
        out = alias = 0
        seen = set()
        for t in _tensors(tree):
            st = t.untyped_storage()
            if t.device != self.device or id(st) in seen:
                continue
            seen.add(id(st))
            n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
            out += n
            key = self._live.get(id(st))
            if key is not None and self._allocs[key][1] == "argument":
                alias += n
        return out, alias

    def __enter__(self):
        count._OPEN.append(self)
        self.record.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self.record.__exit__(*exc)
            count._OPEN.remove(self)
            for f in self._finalizers:      # the count stops with the block
                f.detach()
            self._finalizers = []


def trace(fn, *args, device="meta", **kw):
    """Run ``fn(*args, **kw)`` under a `StepCounter` with ``args`` live
    from the start; returns ``(counter, result)``. The memory record
    follows the reference's ``memory_analysis``: ``peak`` (arguments
    included), ``argument``, ``output`` (the result's storages), ``alias``
    (results updated in place in an argument) and ``temp`` (the rest of
    the peak)."""
    counter = StepCounter(device)
    counter.arguments(args)
    #: the elements of the step's params (its first argument) this rank
    #: holds
    counter.params = sum(t.numel() for t in _tensors(args[0])) \
        if args else 0
    with counter:
        out = fn(*args, **kw)
    output, alias = counter.output_bytes(out)
    counter.memory = {
        "argument_bytes_per_device": counter.argument_bytes,
        "output_bytes_per_device": output,
        "temp_bytes_per_device": counter.peak_bytes - counter.argument_bytes
        - output + alias,
        "alias_bytes_per_device": alias,
        "peak_bytes_per_device": counter.peak_bytes}
    return counter, out


# ---------------------------------------------------------------------------
# the roofline (the reference's fields and rule, H100 constants)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline(cost: dict, coll: Dict[str, int], *, chips: int,
             model_flops_global: float = 0.0) -> Roofline:
    """``cost``: ``{"flops", "bytes accessed"}`` of one rank's step;
    ``coll``: its collective bytes by kind (``group.Record.totals``)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = float(sum(v for k, v in coll.items() if k != "count"))
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = cbytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dom = max(terms, key=terms.get)
    mf = model_flops_global / chips
    return Roofline(
        flops_per_device=flops,
        bytes_per_device=byts,
        coll_bytes_per_device=cbytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dom,
        model_flops=mf,
        useful_ratio=(mf / flops) if flops else 0.0,
    )


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); decode D=tokens=B."""
    n = param_count(cfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch   # one token per sequence


def param_count(cfg, *, active_only: bool = False) -> float:
    """Analytic parameter count (embeddings + blocks)."""
    d, L = cfg.d_model, cfg.num_layers
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    n = cfg.vocab_size * d * 2                         # tok + out
    attn = d * (H + 2 * KV) * Dh + H * Dh * d
    if cfg.family in ("dense", "vlm"):
        n += L * (attn + 3 * d * cfg.d_ff)
    elif cfg.family == "moe":
        E = cfg.experts_per_token if active_only else cfg.num_experts
        n += L * (attn + 3 * d * cfg.d_ff * E)
        if cfg.dense_residual:
            n += L * 3 * d * cfg.dense_d_ff
    elif cfg.family == "ssm":
        di, N, Hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per = d * (2 * di + 2 * N + Hs) + di * d + (cfg.d_conv) * (di + 2 * N)
        n += L * per
    elif cfg.family == "hybrid":
        di, N, Hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per = d * (2 * di + 2 * N + Hs) + di * d + (cfg.d_conv) * (di + 2 * N)
        n += L * per
        n += attn + 3 * d * cfg.d_ff                   # ONE shared block
    elif cfg.family == "encdec":
        n += cfg.encoder_layers * (attn + 2 * d * cfg.d_ff)
        n += L * (2 * attn + 2 * d * cfg.d_ff)         # self + cross
    return float(n)
