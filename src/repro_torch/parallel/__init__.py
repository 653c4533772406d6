"""Data-parallel layout of the training step (port of ``repro.parallel``)."""
