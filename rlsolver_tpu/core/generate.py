"""Seeded synthetic-instance generators.

Distribution parameters exactly match the reference
(`rlsolver/methods/util_generate.py:75-92`):
  BA: networkx.barabasi_albert_graph(n, m=4)
  ER: networkx.erdos_renyi_graph(n, p=0.15)
  PL: networkx.powerlaw_cluster_graph(n, m=4, p=0.05)
all with unit edge weights.

Seeding contract (`rlsolver/methods/util_read_data.py:103-113`): the graph
name "BA_100_ID7" means "seed the RNG with 7, then generate a BA graph with
100 nodes". The reference seeds python's global `random`; we pass the seed to
networkx explicitly, which uses the same underlying `random.Random` stream,
so instances are reproducible across processes here (and statistically match
the reference's distributions).
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np

from rlsolver_tpu.config import GraphType
from rlsolver_tpu.core.graph import Graph

_NAME_RE = re.compile(r"^(BA|ER|PL)_(\d+)(?:_ID(\d+))?$")


def generate_graph(
    graph_type: GraphType, num_nodes: int, seed: Optional[int] = None, name: str = ""
) -> Graph:
    import networkx as nx

    if graph_type == GraphType.BA:
        g = nx.barabasi_albert_graph(n=num_nodes, m=4, seed=seed)
    elif graph_type == GraphType.ER:
        g = nx.erdos_renyi_graph(n=num_nodes, p=0.15, seed=seed)
    elif graph_type == GraphType.PL:
        g = nx.powerlaw_cluster_graph(n=num_nodes, m=4, p=0.05, seed=seed)
    else:
        raise ValueError(f"unknown graph type {graph_type}")
    edge_list = [(a, b, 1.0) for a, b in g.edges]
    if not name:
        name = f"{graph_type.value}_{num_nodes}" + (f"_ID{seed}" if seed is not None else "")
    return Graph.from_edge_list(num_nodes, edge_list, name=name)


def graph_from_name(name: str) -> Graph:
    """Resolve names like 'BA_100_ID7' to a seeded synthetic instance."""
    m = _NAME_RE.match(name)
    if not m:
        raise ValueError(f"not a synthetic graph name: {name!r}")
    gtype = GraphType(m.group(1))
    num_nodes = int(m.group(2))
    seed = int(m.group(3)) if m.group(3) is not None else None
    return generate_graph(gtype, num_nodes, seed=seed, name=name)


def gnm_graph(
    num_nodes: int = 2000,
    num_edges: int = 19990,
    seed: int = 22,
    signed: bool = False,
    name: str = "",
) -> Graph:
    """Seeded G(n, m) random graph: `num_edges` distinct node pairs drawn
    uniformly with numpy. The defaults give a G22-class instance (Gset G22
    has 2000 nodes and 19990 unit-weight edges); `signed=True` draws each
    weight from {-1, +1} with equal odds, the G27-G31 shape."""
    rng = np.random.default_rng(seed)
    keys = np.empty(0, np.int64)
    while keys.size < num_edges:
        a, b = rng.integers(0, num_nodes, size=(2, 2 * (num_edges - keys.size)))
        fresh = np.minimum(a, b) * num_nodes + np.maximum(a, b)
        fresh = fresh[a != b]
        # keep first appearances in draw order, so the edge set depends
        # only on the seed and not on how the draws were batched
        merged = np.concatenate([keys, fresh])
        _, first = np.unique(merged, return_index=True)
        keys = merged[np.sort(first)][:num_edges]
    weights = rng.choice((-1.0, 1.0), size=num_edges) if signed else np.ones(num_edges)
    edges = [
        (int(k // num_nodes), int(k % num_nodes), float(w))
        for k, w in zip(keys, weights)
    ]
    if not name:
        name = f"gnm_{num_nodes}_{num_edges}_{'pm1' if signed else 'unit'}_s{seed}"
    return Graph.from_edge_list(num_nodes, edges, name=name)


def generate_tsp_coords(
    batch: int,
    num_nodes: int,
    low: float = 0.0,
    high: float = 1.0,
    mode: str = "uniform",
    seed: Optional[int] = None,
) -> np.ndarray:
    """Random TSP coordinates [batch, n, 2] (reference `util_generate.py:33-43`)."""
    rng = np.random.default_rng(seed)
    if mode == "uniform":
        return rng.uniform(low, high, size=(batch, num_nodes, 2))
    if mode == "gaussian":
        c = rng.normal(0.0, 1.0, size=(batch, num_nodes, 2))
        return np.interp(c, (c.min(), c.max()), (low, high))
    raise ValueError(f"unknown mode {mode}")


def generate_knapsack(
    num_items: int, seed: Optional[int] = None, max_weight: int = 50, max_profit: int = 250
):
    """Random knapsack with capacity ~= 30% of total weight."""
    from rlsolver_tpu.core.io import KnapsackInstance

    rng = np.random.default_rng(seed)
    weights = rng.integers(1, max_weight + 1, num_items).astype(np.float32)
    profits = rng.integers(1, max_profit + 1, num_items).astype(np.float32)
    capacity = float(np.floor(0.3 * weights.sum()))
    return KnapsackInstance(seed or 0, capacity, weights, profits)
