"""Synthetic data pipeline (port of ``repro.data``)."""
from repro_torch.data.pipeline import (
    PipelineState,
    SyntheticPipeline,
    batch_to_tensors,
    stream_ids,
)

__all__ = ["PipelineState", "SyntheticPipeline", "batch_to_tensors",
           "stream_ids"]
