"""Goemans-Williamson-style maxcut relaxation, as matmuls on the device.

The reference solves the GW semidefinite program with cvxpy + random
hyperplane rounding (`rlsolver/methods/sdp.py:29-86`). A generic SDP solver
is a poor fit for an accelerator; instead this uses the Burer-Monteiro low-rank
factorization: maximize
    sum_{ij} w_ij (1 - v_i . v_j) / 4   over unit vectors v_i in R^k,
which for k >= sqrt(2n) shares the SDP's optimum, via projected (Riemannian)
gradient ascent — all matmuls — followed by batched random
hyperplane rounding. Typically matches or beats the cvxpy pipeline and runs
orders of magnitude faster.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.ops import cut as cut_ops


@dataclasses.dataclass
class SDPConfig:
    rank: int = 0  # 0 -> ceil(sqrt(2n)) rounded up to 8
    num_iters: int = 300
    lr: float = 0.1
    num_roundings: int = 256
    seed: int = 0


def sdp_maxcut(graph: Graph, cfg: SDPConfig = SDPConfig()) -> Tuple[np.ndarray, float]:
    """Returns (best bits, best cut value)."""
    n = graph.num_nodes
    k = cfg.rank or max(8, int(np.ceil(np.sqrt(2 * n) / 8)) * 8)
    adj = jnp.asarray(graph.adjacency_dense(), jnp.float32)
    cg = cut_ops.CutGraph.build(graph, dtype=jnp.float32)
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init, k_round = jax.random.split(key, 3)
    # Step size scaled by the spectral-radius bound (max weighted degree):
    # a fixed step turns the update into power iteration on (I - lr * A)
    # and collapses every v_i onto the Perron eigenvector on dense graphs
    # (all-identical vectors -> every rounding one-sided -> cut 0).
    max_deg = float(np.abs(np.asarray(graph.weighted_degrees())).max()) or 1.0
    step = cfg.lr * 8.0 / max_deg

    @jax.jit
    def optimize(v):
        def body(v, _):
            # d/dv of -1/4 sum w_ij v_i.v_j  ->  ascent direction -A v / 2
            grad = -jnp.matmul(adj, v, preferred_element_type=jnp.float32)
            # Riemannian (tangent) projection keeps the update a rotation
            grad = grad - jnp.sum(grad * v, axis=1, keepdims=True) * v
            v = v + step * grad
            v = v / jnp.linalg.norm(v, axis=1, keepdims=True)
            return v, None

        v, _ = jax.lax.scan(body, v, None, length=cfg.num_iters)
        return v

    @jax.jit
    def round_and_score(v, key):
        h = jax.random.normal(key, (cfg.num_roundings, v.shape[1]))
        bits = (v @ h.T).T > 0  # [R, n]
        return bits, cut_ops.cut_dense(bits, cg)

    v0 = jax.random.normal(k_init, (n, k))
    v0 = v0 / jnp.linalg.norm(v0, axis=1, keepdims=True)
    v = optimize(v0)
    bits, vs = round_and_score(v, k_round)
    i = int(jnp.argmax(vs))
    return np.asarray(bits[i]), float(vs[i])
