"""The machine's hierarchy as tunable levels, the artifacts that carry
one decision table per level, per-level tuning and tuned mesh placement
(port of ``repro.core.topology``: ``model``, ``decision``, ``tune`` and
``placement`` are copies of the reference's numpy modules;
``MeshMapping.apply`` rebuilds a `group.RankMesh`)."""
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
from repro_torch.core.topology.placement import (
    MeshMapping,
    Workload,
    axis_tiers,
    enumerate_mappings,
    identity_mapping,
    price_mapping,
    sweep_mappings,
)
from repro_torch.core.topology.tune import (
    BUCKET_BYTES_CANDIDATES,
    decided_hierarchical_methods,
    flat_time,
    hierarchical_allreduce_time,
    optimal_hierarchical_allreduce_time,
    optimal_machine_allreduce_time,
    pipelined_sync_time,
    sequential_sync_time,
    streamed_sync_time,
    tune_mesh_mapping,
    tune_overlap_schedule,
    tune_topology,
)
