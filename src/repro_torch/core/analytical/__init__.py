"""Communication cost models (port of ``repro.core.analytical``): copies
of the reference's numpy modules ``base``, ``costs``, ``fitting`` and
``hierarchy``."""
from repro_torch.core.analytical.base import (
    DEFAULT_HOCKNEY,
    DEFAULT_LOGGP,
    ICI_ALPHA,
    ICI_BETA,
    VPU_GAMMA,
    CommModel,
    Hockney,
    LogGP,
    LogP,
    PLogP,
    default_plogp,
)
from repro_torch.core.analytical.costs import (
    best_algorithm,
    collective_cost,
    numeric_optimal_segments,
    optimal_segment_size,
    table3_ring_segmented_time,
)
from repro_torch.core.analytical.hierarchy import (
    allreduce_phases,
    best_hierarchical,
    flat_vs_hierarchical,
    hierarchical_allreduce_cost,
    padded_allreduce_schedule,
)
from repro_torch.core.analytical.fitting import (
    fit_hockney,
    fit_loggp,
    fit_plogp,
    prediction_error,
    select_best_model,
)
