"""Deterministic synthetic data pipeline (port of ``repro/data/pipeline.py``).

Token streams are generated from a counter-based hash (splittable, seekable:
batch i is reproducible without generating batches 0..i-1), with host-side
prefetch; numpy in, numpy out, the reference's bits. Stands in for a
tokenized corpus reader; the interface (``batch_at`` / ``__iter__`` of
global batches + ``state`` for checkpoint resume) is what the trainer
depends on.

Each batch entry draws from its own stream, numbered as the reference
numbers it: ``hash(name) & 0x7FFFFFFF``. Python salts its string hash per
process (unless ``PYTHONHASHSEED`` is set), so processes that must see
one global batch (the ranks of a data-parallel run) take the stream ids
of one process: the launcher computes ``stream_ids`` and hands them to
every rank's pipeline.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.registry import train_batch_shapes


_MASK64 = (1 << 64) - 1


def _hash_tokens(seed: int, stream: int, offset: int, n: int,
                 vocab: int) -> np.ndarray:
    """SplitMix64-style counter hash -> tokens in [0, vocab)."""
    # scalar mixing constants are combined in Python-int space masked to 64
    # bits: np.uint64 scalar products raise RuntimeWarning on wraparound
    # (array ops wrap silently), and the wrapped value is exactly what
    # SplitMix64 wants
    stream_mix = np.uint64((int(stream) * 0x9E3779B97F4A7C15) & _MASK64)
    seed_mix = np.uint64((int(seed) * 0xBF58476D1CE4E5B9) & _MASK64)
    idx = np.arange(offset, offset + n, dtype=np.uint64) + stream_mix
    z = idx + seed_mix
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(vocab)).astype(np.int32)


def stream_ids(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """name -> stream id of every batch entry, as this process's
    reference pipeline would number it."""
    return {name: hash(name) & 0x7FFFFFFF
            for name in train_batch_shapes(cfg, shape)}


@dataclasses.dataclass
class PipelineState:
    step: int = 0


class SyntheticPipeline:
    """Yields global batches (dict of numpy arrays) for any architecture.
    ``streams`` (name -> id, from `stream_ids`) fixes the streams across
    processes; by default this process's own ids."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *,
                 seed: int = 0, start_step: int = 0, prefetch: int = 2,
                 streams: Optional[dict] = None):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.state = PipelineState(step=start_step)
        self.prefetch = prefetch
        self._shapes = train_batch_shapes(cfg, shape)
        self.streams = dict(streams) if streams is not None \
            else stream_ids(cfg, shape)

    # ------------------------------------------------------------------
    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        out = {}
        for name, (shp, _) in self._shapes.items():
            n = int(np.prod(shp))
            # next-token labels = tokens shifted, approximated by an
            # independent stream for synthetic data
            out[name] = _hash_tokens(self.seed, self.streams[name], step * n,
                                     n, cfg.vocab_size).reshape(shp)
        return out

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            s = self.state.step
            while not stop.is_set():
                q.put(self.batch_at(s))
                s += 1

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                self.state.step += 1
                yield item
        finally:
            stop.set()


def batch_to_tensors(batch: dict, device,
                     rows: Optional[slice] = None) -> dict:
    """A numpy batch as tensors on ``device`` (token ids int64, other
    entries bf16, the reference's batch dtype for them), optionally only
    ``rows`` of each entry's batch axis."""
    out = {}
    for name, arr in batch.items():
        arr = arr if rows is None else arr[rows]
        t = torch.from_numpy(np.ascontiguousarray(arr))
        t = t.long() if np.issubdtype(arr.dtype, np.integer) \
            else t.to(torch.bfloat16)
        out[name] = t.to(device)
    return out
