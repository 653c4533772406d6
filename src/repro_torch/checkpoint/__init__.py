"""Checkpoints of the port's trees (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import restore, save

__all__ = ["restore", "save"]
