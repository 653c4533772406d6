"""The machine's hierarchy as tunable levels, and the artifacts that carry
one decision table per level (port of ``repro.core.topology``: ``model``
and ``decision``, copies of the reference's numpy modules).
``placement`` and ``tune`` are not ported yet (ROADMAP.md Queue 1,
step 5)."""
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
