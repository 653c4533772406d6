"""Communication cost models (port of ``repro.core.analytical``).

Only ``base`` is ported so far: the simulator and the synthesizer need
it. ``costs``, ``fitting`` and ``hierarchy`` come with a later slice.
"""
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
