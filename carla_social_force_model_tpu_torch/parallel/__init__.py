"""Agent sharding: pedestrian slots split over shards, ensembles and
parameter sweeps (``sweeps``), and both over a 2-D (batch, agents) mesh
(port of parallel/)."""

from .mesh import (AGENT_AXIS, BATCH_AXIS, AgentAxis, LocalMesh,  # noqa: F401
                   ProcessGroupAxis, make_mesh, round_up)

__all__ = ["AGENT_AXIS", "BATCH_AXIS", "AgentAxis", "LocalMesh",
           "ProcessGroupAxis", "make_mesh", "round_up"]
