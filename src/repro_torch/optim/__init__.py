"""AdamW and learning-rate schedules (port of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.optim.schedule import constant, cosine_with_warmup

__all__ = ["AdamW", "AdamWState", "constant", "cosine_with_warmup",
           "global_norm"]
