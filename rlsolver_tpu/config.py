"""Global problem / graph-type axes and typed run configuration.

The reference keeps these as module-level constants edited in place
(`rlsolver/methods/config.py:9-83`). Here they are a typed config tree with
the same four axes the reference uses everywhere: problem, algorithm,
graph type, and size.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Problem(enum.Enum):
    """Problem axis (reference: `rlsolver/methods/config.py:18-32`)."""

    maxcut = "maxcut"
    graph_partitioning = "graph_partitioning"
    number_partitioning = "number_partitioning"
    minimum_vertex_cover = "minimum_vertex_cover"
    bilp = "bilp"
    maximum_independent_set = "maximum_independent_set"
    knapsack = "knapsack"
    set_cover = "set_cover"
    graph_coloring = "graph_coloring"
    portfolio_allocation = "portfolio_allocation"
    tnco = "tnco"
    vrp = "vrp"
    tsp = "tsp"


class GraphType(enum.Enum):
    """Synthetic graph distributions (reference: `config.py:9-12`)."""

    BA = "BA"  # Barabasi-Albert, m=4
    ER = "ER"  # Erdos-Renyi, p=0.15
    PL = "PL"  # powerlaw cluster, m=4, p=0.05


# Problems whose objective is maximized. Mirrors the reference's per-method
# `if_maximize` flags (e.g. `envs/env_L2A.py:30`).
MAXIMIZE_PROBLEMS = frozenset(
    {
        Problem.maxcut,
        Problem.maximum_independent_set,
        Problem.knapsack,
        Problem.graph_partitioning,
        Problem.portfolio_allocation,
    }
)


def is_maximize(problem: Problem) -> bool:
    return problem in MAXIMIZE_PROBLEMS


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Which instances to run on."""

    graph_type: Optional[GraphType] = GraphType.BA
    num_nodes: int = 100
    # Seeded instance id; `BA_100_ID7` in the reference means
    # `random.seed(7)` + generate (`util_read_data.py:103-113`).
    instance_id: Optional[int] = None
    # Or an explicit file path (gset/syn txt format).
    path: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Vectorized-environment axis."""

    num_sims: int = 1024
    dtype: str = "bfloat16"  # matmul storage dtype for dense objectives
    # "dense" = (x A) x matmul; "sparse" = edge-gather segment sum;
    # "auto" picks by density.
    objective_mode: str = "auto"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh for sharding the env axis (SURVEY.md section 2.9 P2)."""

    num_devices: Optional[int] = None  # None = all local devices
    axis_name: str = "env"


@dataclasses.dataclass(frozen=True)
class RunConfig:
    problem: Problem = Problem.maxcut
    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    seed: int = 0
    result_dir: str = "result"


# Data directory conventions mirroring the reference's `data/` tree.
DATA_SUBDIR_BY_GRAPH_TYPE = {
    GraphType.BA: "syn_BA",
    GraphType.ER: "syn_ER",
    GraphType.PL: "syn_PL",
}
