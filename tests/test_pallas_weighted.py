"""General-integer-weight bit-plane tables of the sweep kernel, and the
kernel on them (interpret mode) against the XLA twin."""

import jax
import numpy as np
import pytest

from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.ops.pallas.mcpg_sweep import (
    WeightedSweepTables,
    mcpg_sweep_fused,
    mcpg_sweep_reference,
    sweep_noise_grid,
)


def weighted_graph(n=72, seed=3, w_max=5, signed=True):
    rng = np.random.default_rng(seed)
    edges = []
    for i in range(n):
        for j in rng.choice(n, size=4, replace=False):
            if i < j:
                w = int(rng.integers(1, w_max + 1))
                if signed and rng.random() < 0.4:
                    w = -w
                edges.append((i, int(j), float(w)))
    return Graph.from_edge_list(n, edges, name=f"W{n}")


def test_tables_plane_reconstruction():
    g = weighted_graph()
    t = WeightedSweepTables.build(g)
    adj = np.asarray(g.adjacency_dense())
    order = np.asarray(t.nodes)
    n = g.num_nodes
    k = t.k_planes

    def unpack(m):
        words = np.asarray(m).view(np.uint32)
        bits = ((words[:, :, None] >> np.arange(32)) & 1).astype(bool)
        return bits.reshape(m.shape[0], -1)[:, :n]

    recon = np.zeros((n, n))
    for b in range(k):
        recon += (1 << b) * unpack(t.masks[1 + b])
        recon -= (1 << b) * unpack(t.masks[1 + k + b])
    np.testing.assert_array_equal(recon, adj[order])
    # plane 0 is the earlier-in-order table
    pos = np.empty(n, int)
    pos[order] = np.arange(n)
    np.testing.assert_array_equal(
        unpack(t.masks[0]), pos[None, :] < np.arange(n)[:, None]
    )


def _check(g, b, sweeps, seed):
    t = WeightedSweepTables.build(g)
    bits = jax.random.bernoulli(jax.random.PRNGKey(seed), 0.5, (b, g.num_nodes))
    out = mcpg_sweep_fused(seed, bits, t, num_sweeps=sweeps, interpret=True)
    noise = sweep_noise_grid(seed, b, sweeps * g.num_nodes)
    ref = mcpg_sweep_reference(noise, bits, t, g, num_sweeps=sweeps)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    return t


def test_weighted_sweep_bit_exact_vs_twin():
    t = _check(weighted_graph(), b=16, sweeps=3, seed=0)
    assert t.has_neg and t.k_planes == 3


def test_weighted_sweep_unsigned_graph():
    t = _check(weighted_graph(n=40, seed=7, w_max=6, signed=False), b=8, sweeps=1, seed=2)
    assert not t.has_neg and t.masks.shape[0] == 1 + t.k_planes


def test_non_integer_weights_rejected():
    g = Graph.from_edge_list(4, [(0, 1, 0.5), (1, 2, 1.0)], name="frac")
    with pytest.raises(ValueError, match="integer"):
        WeightedSweepTables.build(g)
