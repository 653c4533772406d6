"""The tuning core (port of ``repro.core.tuning``).

``space``, ``decision``, ``simulator``, ``session``, ``exhaustive``,
``heuristic`` and the modules of every other tuner family
(``preprocess``, ``regression``, ``ann``, ``ensemble``,
``decision_tree``, ``quadtree``, ``octree``, ``star``, ``feedback``,
``umtac``) are copies of the reference's numpy modules; artifact JSON
keeps its format, so a table written by either package loads in the
other. ``executor`` adds a PyTorch ``DeviceBackend`` that times the
port's algorithms inside every rank of a process group. ``tuners`` has
all twelve of the reference's tuners.
"""
from repro_torch.core.tuning.decision import (
    DecisionTable,
    TableMeta,
    mean_penalty,
)
from repro_torch.core.tuning.executor import (
    BenchmarkExecutor,
    Dataset,
    DeviceBackend,
    Measurement,
    SimulatorBackend,
)
from repro_torch.core.tuning.session import (
    TunerReport,
    TuningSession,
    empirical_penalty,
)
from repro_torch.core.tuning.simulator import (
    NetworkProfile,
    NetworkSimulator,
    drifted,
)
from repro_torch.core.tuning.space import (
    DECODE_MESSAGE_SIZES,
    MESSAGE_SIZES,
    OPS,
    PROCESS_COUNTS,
    SEGMENT_CANDIDATES,
    Method,
    Point,
    grid,
    methods_for,
)
from repro_torch.core.tuning.tuners import TUNERS, Tuner, make_tuner
