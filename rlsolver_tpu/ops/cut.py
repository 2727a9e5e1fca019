"""Batched maxcut / Ising reductions — the framework's hottest ops.

Two formulations, both present in the reference (SURVEY.md section 7.1
decision 2):

  * dense: cut(x) = W/2 - s A s^T / 4 with s = 2x-1, computed as one
    [B,N]x[N,N] matmul on the tensor cores (reference's fp16 "tensor-core" path,
    `rlsolver/envs/env_ISCO.py:436-444`). Default for N up to ~10k.
  * sparse: cut(x) = sum_e w_e * (x[n0_e] XOR x[n1_e]) via gathers along the
    edge axis (reference's edge-index path, `rlsolver/envs/env_L2A.py:54-66`).
    Wins for very sparse giants (G70: 10k nodes, 9999 edges).

Flip gains: Delta_cut(flip i) = s_i * (A s)_i — one more matmul. This single
identity powers local search, greedy, ECO observables and MCMC proposals.

Numerical contract: adjacency weights are stored in `dtype` (default
bfloat16 — exact for the small-integer weights of Gset/synthetic graphs) and
all matmuls accumulate in float32 (`preferred_element_type`), which is exact
for cut values below 2^24.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from rlsolver_tpu.core.graph import Graph


class CutGraph(NamedTuple):
    """Device-resident static graph data for cut computations.

    `adj` is the symmetric dense adjacency (present unless sparse_only);
    `n0/n1/w` are flat per-edge endpoint/weight arrays (each edge once);
    `deg_w` is the weighted degree vector; `total_w` the total edge weight.
    """

    num_nodes: int
    adj: Optional[jax.Array]  # [n, n] dtype
    n0: jax.Array  # [m] int32
    n1: jax.Array  # [m] int32
    w: jax.Array  # [m] f32
    deg_w: jax.Array  # [n] f32
    total_w: jax.Array  # scalar f32

    @staticmethod
    def build(graph: Graph, dtype=jnp.bfloat16, with_dense: bool = True) -> "CutGraph":
        n0, n1, w = graph.edge_arrays()
        return CutGraph(
            num_nodes=graph.num_nodes,
            adj=jnp.asarray(graph.adjacency_dense(), dtype) if with_dense else None,
            n0=jnp.asarray(n0),
            n1=jnp.asarray(n1),
            w=jnp.asarray(w),
            deg_w=jnp.asarray(graph.weighted_degrees()),
            total_w=jnp.float32(graph.total_weight),
        )


def signs_from_bits(xs: jax.Array, dtype=jnp.bfloat16) -> jax.Array:
    """{0,1} bits -> {-1,+1} signs in matmul dtype (exact in bfloat16)."""
    return (2 * xs.astype(jnp.int8) - 1).astype(dtype)


# ------------------------------------------------------------------ objective
def cut_dense(xs: jax.Array, cg: CutGraph) -> jax.Array:
    """Batched cut value via one matmul. xs: bool/int [B, N] -> f32 [B]."""
    s = signs_from_bits(xs, cg.adj.dtype)
    sa = jnp.dot(s, cg.adj, preferred_element_type=jnp.float32)  # [B, N]
    quad = jnp.sum(sa * s.astype(jnp.float32), axis=-1)  # s A s^T
    return 0.5 * cg.total_w - 0.25 * quad


def cut_sparse(xs: jax.Array, cg: CutGraph) -> jax.Array:
    """Batched cut value via edge gathers. xs: bool/int [B, N] -> f32 [B]."""
    xb = xs.astype(jnp.int8)
    cut_e = (xb[:, cg.n0] ^ xb[:, cg.n1]).astype(jnp.float32)  # [B, m]
    return cut_e @ cg.w


def cut_value(xs: jax.Array, cg: CutGraph, mode: str = "auto") -> jax.Array:
    if mode == "dense" or (mode == "auto" and cg.adj is not None and _prefer_dense(cg)):
        return cut_dense(xs, cg)
    return cut_sparse(xs, cg)


def _prefer_dense(cg: CutGraph) -> bool:
    # Dense matmul does n^2 bf16 MACs on the tensor cores; sparse does ~2m
    # gathers. The rule keeps dense except for very sparse graphs; its
    # crossover was never measured on the GPU (ROADMAP A5).
    n = cg.num_nodes
    m = cg.n0.shape[0]
    return n * n <= 256 * m


# ----------------------------------------------------------------- flip gains
def flip_gains_dense(xs: jax.Array, cg: CutGraph) -> jax.Array:
    """gain[b, i] = cut(flip(x_b, i)) - cut(x_b) = s_i (A s)_i. -> f32 [B, N]."""
    s = signs_from_bits(xs, cg.adj.dtype)
    sa = jnp.dot(s, cg.adj, preferred_element_type=jnp.float32)
    return sa * s.astype(jnp.float32)


def flip_gains_sparse(xs: jax.Array, cg: CutGraph) -> jax.Array:
    """Flip gains via per-edge scatter-add: gain_i = deg_i - 2*contrib_i."""
    return cg.deg_w[None, :] - 2.0 * node_cut_contrib_sparse(xs, cg)


def node_cut_contrib_sparse(xs: jax.Array, cg: CutGraph) -> jax.Array:
    """contrib[b, i] = sum_{j in N(i)} w_ij * (x_i XOR x_j). -> f32 [B, N].

    Matches the reference's per-node cut contributions
    (`calculate_obj_values_for_loop`, `rlsolver/envs/env_L2A.py:68-80`).
    """
    xb = xs.astype(jnp.int8)
    cut_e = (xb[:, cg.n0] ^ xb[:, cg.n1]).astype(jnp.float32) * cg.w[None, :]
    num_segments = cg.num_nodes
    seg = functools.partial(
        jax.ops.segment_sum, num_segments=num_segments, indices_are_sorted=False
    )
    contrib = jax.vmap(lambda ce: seg(ce, cg.n0) + seg(ce, cg.n1))(cut_e)
    return contrib


def node_cut_contrib_dense(xs: jax.Array, cg: CutGraph) -> jax.Array:
    return 0.5 * (cg.deg_w[None, :] - flip_gains_dense(xs, cg))


def flip_gains(xs: jax.Array, cg: CutGraph, mode: str = "auto") -> jax.Array:
    if mode == "dense" or (mode == "auto" and cg.adj is not None and _prefer_dense(cg)):
        return flip_gains_dense(xs, cg)
    return flip_gains_sparse(xs, cg)


# ------------------------------------------------------------ incremental ops
def apply_flip_update_gains(
    s: jax.Array, gains: jax.Array, node: jax.Array, adj_row: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Flip `node` in every row of signed state `s` and update `gains`.

    s: f32 [B, N] signed +-1; gains: f32 [B, N]; node: scalar int;
    adj_row: f32 [N] = A[node, :]. Rank-1 update derived from
    gain_j = s_j (A s)_j:
        gain_j' = gain_j - 2 s_j s_i A_ij   (j != i),  gain_i' = -gain_i.
    """
    s_i = s[:, node]  # [B]
    delta = -2.0 * s_i[:, None] * s * adj_row[None, :]  # [B, N]
    gains_new = gains + delta
    gains_new = gains_new.at[:, node].set(-gains[:, node])
    s_new = s.at[:, node].multiply(-1.0)
    return s_new, gains_new
