"""Host-side graph container and array builders.

The reference passes graphs around as `MyGraph = List[(n0, n1, weight)]` with
0-indexed nodes and builds three device layouts from it: a dense bool/weight
adjacency (`rlsolver/methods/util.py:312,343`), per-node neighbor index lists
(`util_read_data.py:144`), and flat edge-endpoint index tensors
(`envs/env_L2A.py:46-52`). This module provides the same three layouts as
static numpy arrays suitable for closing over in jitted JAX programs:

  * dense symmetric adjacency  -> matmul objectives
  * flat edge arrays (n0, n1, w) -> sparse gather/segment-sum objectives
  * padded neighbor table      -> sequential/colored local-search sweeps

Everything here is host-side numpy; device placement happens where the arrays
are closed over by a jitted function.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

EdgeList = Sequence[Tuple[int, int, float]]


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected weighted graph. Edges are stored once (n0 < n1)."""

    num_nodes: int
    edges: np.ndarray  # [m, 2] int32, 0-indexed, edges[i, 0] < edges[i, 1]
    weights: np.ndarray  # [m] float32
    name: str = ""

    # ---------------------------------------------------------------- basic
    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def total_weight(self) -> float:
        return float(self.weights.sum())

    @property
    def density(self) -> float:
        n = self.num_nodes
        return 0.0 if n < 2 else 2.0 * self.num_edges / (n * (n - 1))

    # ----------------------------------------------------------- constructors
    @staticmethod
    def from_edge_list(num_nodes: int, edge_list: EdgeList, name: str = "") -> "Graph":
        """Build from (n0, n1, w) triples; merges duplicate/reversed edges."""
        if len(edge_list) == 0:
            return Graph(num_nodes, np.zeros((0, 2), np.int32), np.zeros((0,), np.float32), name)
        arr = np.asarray([(min(a, b), max(a, b), w) for a, b, w in edge_list], dtype=np.float64)
        ends = arr[:, :2].astype(np.int64)
        # Deduplicate (keep the last weight, matching nx.Graph.add_edge overwrite).
        key = ends[:, 0] * num_nodes + ends[:, 1]
        order = np.arange(len(key))
        last = {}
        for i in order:
            last[key[i]] = i
        keep = np.asarray(sorted(last.values(), key=lambda i: (ends[i, 0], ends[i, 1])), dtype=np.int64)
        edges = ends[keep].astype(np.int32)
        weights = arr[keep, 2].astype(np.float32)
        if (edges[:, 0] == edges[:, 1]).any():
            raise ValueError("self-loops are not supported")
        if edges.size and (edges.min() < 0 or edges.max() >= num_nodes):
            raise ValueError("edge endpoint out of range")
        return Graph(num_nodes, edges, weights, name)

    @staticmethod
    def from_networkx(g, name: str = "") -> "Graph":
        edge_list = [(u, v, float(d.get("weight", 1.0))) for u, v, d in g.edges(data=True)]
        return Graph.from_edge_list(g.number_of_nodes(), edge_list, name)

    def to_networkx(self):
        import networkx as nx

        g = nx.Graph()
        g.add_nodes_from(range(self.num_nodes))
        for (a, b), w in zip(self.edges, self.weights):
            g.add_edge(int(a), int(b), weight=float(w))
        return g

    def to_edge_list(self) -> List[Tuple[int, int, float]]:
        return [(int(a), int(b), float(w)) for (a, b), w in zip(self.edges, self.weights)]

    # -------------------------------------------------------------- layouts
    def adjacency_dense(self, dtype=np.float32) -> np.ndarray:
        """Symmetric dense adjacency [n, n]; A[i, j] = w(i, j), 0 if no edge."""
        a = np.zeros((self.num_nodes, self.num_nodes), dtype=np.float32)
        i, j = self.edges[:, 0], self.edges[:, 1]
        a[i, j] = self.weights
        a[j, i] = self.weights
        return a.astype(dtype)

    def degrees(self) -> np.ndarray:
        """Unweighted degree per node, int32."""
        deg = np.zeros(self.num_nodes, np.int32)
        np.add.at(deg, self.edges[:, 0], 1)
        np.add.at(deg, self.edges[:, 1], 1)
        return deg

    def weighted_degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_nodes, np.float32)
        np.add.at(deg, self.edges[:, 0], self.weights)
        np.add.at(deg, self.edges[:, 1], self.weights)
        return deg

    def edge_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(n0, n1, w) flat arrays, each edge once."""
        return (
            self.edges[:, 0].astype(np.int32),
            self.edges[:, 1].astype(np.int32),
            self.weights.astype(np.float32),
        )

    def padded_neighbors(
        self, pad_multiple: int = 8
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Padded neighbor table.

        Returns (nbrs [n, max_deg], nbr_w [n, max_deg], deg [n]).
        Padding slots point at node index `num_nodes` (a sentinel row the
        consumer must append / mask) with weight 0, so gathered padded
        neighbors contribute nothing to weighted sums.
        """
        deg = self.degrees()
        max_deg = int(deg.max(initial=0))
        max_deg = max(1, -(-max_deg // pad_multiple) * pad_multiple)
        nbrs = np.full((self.num_nodes, max_deg), self.num_nodes, np.int32)
        nbr_w = np.zeros((self.num_nodes, max_deg), np.float32)
        fill = np.zeros(self.num_nodes, np.int32)
        for (a, b), w in zip(self.edges, self.weights):
            nbrs[a, fill[a]] = b
            nbr_w[a, fill[a]] = w
            fill[a] += 1
            nbrs[b, fill[b]] = a
            nbr_w[b, fill[b]] = w
            fill[b] += 1
        return nbrs, nbr_w, deg

    def degree_sorted_nodes(self, descending: bool = True) -> np.ndarray:
        """Node order for degree-ordered sweeps (MCPG `sorted_degree_nodes`)."""
        deg = self.weighted_degrees()
        order = np.argsort(-deg if descending else deg, kind="stable")
        return order.astype(np.int32)

    def greedy_coloring(self) -> Tuple[np.ndarray, int]:
        """Greedy node coloring (largest-degree-first).

        Used to parallelize Gauss-Seidel local-search sweeps: nodes within a
        color class share no edge, so they can be updated simultaneously.
        Returns (color [n] int32, num_colors).
        """
        order = self.degree_sorted_nodes(descending=True)
        nbrs, _, deg = self.padded_neighbors()
        color = np.full(self.num_nodes, -1, np.int32)
        for v in order:
            used = set()
            for k in range(deg[v]):
                c = color[nbrs[v, k]]
                if c >= 0:
                    used.add(int(c))
            c = 0
            while c in used:
                c += 1
            color[v] = c
        return color, int(color.max(initial=-1)) + 1
