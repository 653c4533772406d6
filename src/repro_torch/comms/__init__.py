"""`repro_torch.comms` — the one tuned-collective API (port of
``repro.comms``).

`Communicator.create(...)` resolves probe -> select -> decide -> dispatch
once per launch; every consumer dispatches through its op methods and
can ask `explain()` why any schedule was chosen. The topology
re-exports are those of the ported ``core.topology`` modules (``model``
and ``decision``).
"""
from repro_torch.comms.bucketing import Bucket, BucketLayout, coalesce_bytes
from repro_torch.comms.communicator import Communicator
from repro_torch.comms.probe import (
    level_probe_pairs,
    probe_live_profile,
    probe_mesh_topology,
)
from repro_torch.comms.report import PlanEntry, PlanReport
from repro_torch.comms.request import CollectiveRequest
from repro_torch.core.topology.decision import (
    MULTI_SCHEMA_VERSION,
    HierarchicalDecision,
    MultiProfileArtifact,
    load_decision,
    profile_distance,
)
from repro_torch.core.topology.model import (
    DEFAULT_LEVEL_PROFILES,
    LEVEL_NAMES,
    SYNC_AXES,
    MeshLevel,
    Topology,
    fit_profile,
    level_names_for,
    probe_profile,
    probe_topology,
)
