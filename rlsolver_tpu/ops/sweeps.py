"""Sequential (Gauss-Seidel) local-search sweeps as jittable scans.

MCPG's sampler runs a *degree-ordered sequential* anti-majority sweep: for
each node in descending-degree order, set x_i = 1 iff the (noisy) sum of its
neighbors' current values is below half its weighted degree
(`rlsolver/methods/MCPG.py:120-141`). The per-node state mixes two value
domains by construction: unprocessed nodes carry 2x-0.5 in {-0.5, 1.5},
processed ones carry {0, 1} — reproduced here exactly.

This is the part of the reference that "resists naive vmap" (SURVEY.md
section 3.2): the sweep is inherently sequential per env. Here it is a
`lax.scan` over the node axis with padded-neighbor gathers, batched over all
envs — O(B * max_deg) elementwise work per node, all inside one jit.

A color-parallel variant (`colored_sweep`) updates whole independent color
classes at once — a different (typically equally good) heuristic fixpoint
that replaces N sequential steps with num_colors matmul steps.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rlsolver_tpu.core.graph import Graph


class SweepData(NamedTuple):
    """Static per-instance arrays for sweeps, in sweep order."""

    order: jax.Array  # [N] int32 node ids, descending degree
    nbrs: jax.Array  # [N, max_deg] int32 neighbor table in sweep order (sentinel N)
    nbr_w: jax.Array  # [N, max_deg] f32 weights in sweep order
    wdeg: jax.Array  # [N] f32 weighted degree in sweep order
    color_masks: jax.Array  # [num_colors, N] bool — independent classes (node order)
    num_nodes: int

    @staticmethod
    def build(graph: Graph) -> "SweepData":
        order = graph.degree_sorted_nodes(descending=True)
        nbrs, nbr_w, _ = graph.padded_neighbors()
        wdeg = graph.weighted_degrees()
        color, num_colors = graph.greedy_coloring()
        masks = np.stack([color == c for c in range(num_colors)])
        return SweepData(
            order=jnp.asarray(order),
            nbrs=jnp.asarray(nbrs[order]),
            nbr_w=jnp.asarray(nbr_w[order]),
            wdeg=jnp.asarray(wdeg[order]),
            color_masks=jnp.asarray(masks),
            num_nodes=graph.num_nodes,
        )


def mcpg_init_values(xs: jax.Array) -> jax.Array:
    """{0,1} bits -> the sweep's mixed start domain 2x - 0.5 in {-0.5, 1.5},
    with the sentinel slot appended (always 0)."""
    xt = 2.0 * xs.astype(jnp.float32) - 0.5
    pad = jnp.zeros((xt.shape[0], 1), jnp.float32)
    return jnp.concatenate([xt, pad], axis=1)  # [B, N+1]


def degree_ordered_sweep(
    key: jax.Array,
    xt: jax.Array,
    data: SweepData,
    num_sweeps: int = 1,
    noise_scale: float = 0.25,
) -> jax.Array:
    """Run `num_sweeps` sequential anti-majority sweeps. xt: [B, N+1] mixed
    domain (see `mcpg_init_values`); returns xt with all entries in {0, 1}.
    """
    num_nodes = data.num_nodes

    def node_step(xt, inp):
        node, nbr_row, w_row, wd, k = inp
        vals = jnp.take(xt, nbr_row, axis=1)  # [B, max_deg]
        nbr_sum = jnp.sum(vals * w_row[None, :], axis=1)  # [B]
        u = jax.random.uniform(k, (xt.shape[0],))
        new_bit = (nbr_sum + u * noise_scale) < (wd + noise_scale) / 2.0
        xt = xt.at[:, node].set(new_bit.astype(jnp.float32))
        return xt, None

    def one_sweep(xt, k):
        keys = jax.random.split(k, num_nodes)
        xt, _ = jax.lax.scan(
            node_step, xt, (data.order, data.nbrs, data.nbr_w, data.wdeg, keys)
        )
        return xt, None

    xt, _ = jax.lax.scan(one_sweep, xt, jax.random.split(key, num_sweeps))
    return xt


def edge_pair_sweep(
    key: jax.Array,
    xs: jax.Array,
    graph: Graph,
    num_sweeps: int = 1,
    noise_scale: float = 0.1,
) -> jax.Array:
    """Edge-oriented pair sweep (`mcpg_sampling_maxcut_edge`,
    reference `MCPG/sampling.py:130-180`): visit edges in descending
    endpoint-degree order; for edge (r, c) jointly pick the (x_r, x_c)
    combination maximizing the local cut contribution

        f(x_r, x_c) = cut(r, others) + cut(c, others) + w_rc [x_r != x_c]

    with small exploration noise. Maintains the field h = x @ A
    incrementally (the reference recomputes per-edge neighbor matvecs).
    xs: bool [B, N]; returns bool [B, N].
    """
    adj_np = graph.adjacency_dense()
    adj = jnp.asarray(adj_np)
    wdeg_np = graph.weighted_degrees()
    e0, e1, ew = graph.edge_arrays()
    order = np.argsort(-(wdeg_np[e0] + wdeg_np[e1]))
    er, ec, ww = e0[order], e1[order], ew[order]
    # pre-gathered per-edge data as scan inputs: the compile stays small
    # because the scan body contains no dynamic row gathers from adj
    row_r = jnp.asarray(adj_np[er])  # [E, N]
    row_c = jnp.asarray(adj_np[ec])
    onehot_r = jax.nn.one_hot(jnp.asarray(er), graph.num_nodes)  # [E, N]
    onehot_c = jax.nn.one_hot(jnp.asarray(ec), graph.num_nodes)
    t_r = jnp.asarray(wdeg_np[er] - ww)
    t_c = jnp.asarray(wdeg_np[ec] - ww)
    ww_j = jnp.asarray(ww)

    x = xs.astype(jnp.float32)
    h = x @ adj  # [B, N] neighbor-weight sums

    def step(carry, inp):
        x, h = carry
        oh_r, oh_c, rr, rc, w, tr, tc, k = inp
        xr = x @ oh_r  # [B] — onehot gathers, no dynamic indices
        xc = x @ oh_c
        s_r = h @ oh_r - w * xc  # set-1 neighbor weight excluding partner
        s_c = h @ oh_c - w * xr
        noise = jax.random.uniform(k, (4, x.shape[0])) * noise_scale
        f00 = s_r + s_c + noise[0]
        f01 = s_r + (tc - s_c) + w + noise[1]
        f10 = (tr - s_r) + s_c + w + noise[2]
        f11 = (tr - s_r) + (tc - s_c) + noise[3]
        choice = jnp.argmax(jnp.stack([f00, f01, f10, f11]), axis=0)
        new_r = (choice >= 2).astype(jnp.float32)
        new_c = (choice % 2).astype(jnp.float32)
        h = h + (new_r - xr)[:, None] * rr[None, :]
        h = h + (new_c - xc)[:, None] * rc[None, :]
        x = x + (new_r - xr)[:, None] * oh_r[None, :]
        x = x + (new_c - xc)[:, None] * oh_c[None, :]
        return (x, h), None

    m = er.shape[0]
    keys = jax.random.split(key, m * num_sweeps)
    tile = lambda a: jnp.tile(a, (num_sweeps,) + (1,) * (a.ndim - 1))
    seq = (
        tile(onehot_r), tile(onehot_c), tile(row_r), tile(row_c),
        tile(ww_j), tile(t_r), tile(t_c), keys,
    )
    (x, _), _ = jax.lax.scan(step, (x, h), seq)
    return x > 0.5


def colored_sweep(
    key: jax.Array,
    xs: jax.Array,
    adj: jax.Array,
    wdeg: jax.Array,
    color_masks: jax.Array,
    num_sweeps: int = 1,
    noise_scale: float = 0.25,
) -> jax.Array:
    """Color-parallel anti-majority sweep on {0,1} bits (matmul formulation).

    Per color class, neighbor sums for the whole class come from one
    [B,N]x[N,N] matmul; nodes within a class share no edge, so the joint
    update equals a sequential within-class sweep. xs: f32 {0,1} [B, N].
    """
    num_colors = color_masks.shape[0]

    def class_step(xs, inp):
        mask, k = inp  # [N] bool
        nbr_sum = jnp.matmul(
            xs, adj, preferred_element_type=jnp.float32
        )  # [B, N]
        u = jax.random.uniform(k, xs.shape)
        new_bits = ((nbr_sum + u * noise_scale) < (wdeg + noise_scale) / 2.0).astype(
            jnp.float32
        )
        return jnp.where(mask[None, :], new_bits, xs), None

    def one_sweep(xs, k):
        keys = jax.random.split(k, num_colors)
        xs, _ = jax.lax.scan(class_step, xs, (color_masks, keys))
        return xs, None

    xs, _ = jax.lax.scan(one_sweep, xs, jax.random.split(key, num_sweeps))
    return xs
