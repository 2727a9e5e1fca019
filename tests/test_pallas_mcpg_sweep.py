"""Bit-packed MCPG sweep kernel (Pallas, Triton route): bit-exact parity
with the XLA twin in interpret mode, and zero-noise equivalence of the twin
with the production `degree_ordered_sweep`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rlsolver_tpu.core.generate import gnm_graph, graph_from_name
from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.ops.pallas.mcpg_sweep import (
    WeightedSweepTables,
    mcpg_sweep_fused,
    mcpg_sweep_reference,
    sweep_noise_grid,
)
from rlsolver_tpu.ops.sweeps import SweepData, degree_ordered_sweep, mcpg_init_values


def weighted_graph(n, seed, w_max, signed, degree=4):
    rng = np.random.default_rng(seed)
    edges = []
    for i in range(n):
        for j in rng.choice(n, size=degree, replace=False):
            if i < j:
                w = int(rng.integers(1, w_max + 1))
                if signed and rng.random() < 0.4:
                    w = -w
                edges.append((i, int(j), float(w)))
    return Graph.from_edge_list(n, edges, name=f"W{n}")


def _kernel_vs_twin(g, b, sweeps, seed=9):
    t = WeightedSweepTables.build(g)
    bits = jax.random.bernoulli(jax.random.PRNGKey(seed), 0.5, (b, g.num_nodes))
    out = mcpg_sweep_fused(jnp.int32(seed), bits, t, num_sweeps=sweeps, interpret=True)
    noise = sweep_noise_grid(seed, b, sweeps * g.num_nodes)
    ref = mcpg_sweep_reference(noise, bits, t, g, num_sweeps=sweeps)
    assert out.shape == (b, g.num_nodes)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    return t, bits, out


@pytest.mark.parametrize(
    "n,w_max,signed,b,sweeps",
    [
        (14, 1, False, 8, 1),  # unit weights, one word, chains = block
        (14, 1, True, 13, 3),  # +-1 weights, partial block
        (100, 1, False, 33, 3),
        (100, 1, True, 16, 1),
        (100, 7, True, 12, 3),  # 3 signed bit-planes
        (100, 5, False, 8, 1),  # 3 unsigned bit-planes
        (1000, 1, True, 9, 1),  # N not a multiple of 32
        (1000, 7, False, 8, 1),
    ],
)
def test_fused_bit_exact_vs_twin(n, w_max, signed, b, sweeps):
    g = weighted_graph(n, seed=n + b, w_max=w_max, signed=signed)
    t, _, _ = _kernel_vs_twin(g, b, sweeps)
    assert t.k_planes == w_max.bit_length() and t.has_neg == signed


@pytest.fixture(scope="module", params=["BA_100_ID0", "ER_64_ID1"])
def setup(request):
    g = graph_from_name(request.param)
    return g, WeightedSweepTables.build(g)


def test_packed_sweep_bit_exact_vs_twin(setup):
    g, _ = setup
    _kernel_vs_twin(g, 128, 3, seed=1)


def test_twin_equals_xla_sweep_at_zero_noise(setup):
    # with zero noise every quantity is an exact f32 integer/half, so the
    # popcount formulation is provably identical to the gather formulation
    g, tables = setup
    B, N = 64, g.num_nodes
    bits = jax.random.bernoulli(jax.random.PRNGKey(2), 0.5, (B, N))
    zero = jnp.zeros((2 * N, B), jnp.int32)
    ref0 = mcpg_sweep_reference(zero, bits, tables, g, num_sweeps=2, noise_scale=0.0)
    data = SweepData.build(g)
    xt = degree_ordered_sweep(
        jax.random.PRNGKey(3), mcpg_init_values(bits), data, num_sweeps=2,
        noise_scale=0.0,
    )
    np.testing.assert_array_equal(np.asarray(ref0), np.asarray(xt[:, :N] > 0.5))


def test_sweep_improves_objective(setup):
    from rlsolver_tpu.envs.maxcut import MaxcutEnv

    g, tables = setup
    env = MaxcutEnv(g)
    bits = jax.random.bernoulli(jax.random.PRNGKey(4), 0.5, (128, g.num_nodes))
    out = mcpg_sweep_fused(jnp.int32(5), bits, tables, num_sweeps=2, interpret=True)
    assert float(jnp.mean(env.obj(out))) > float(jnp.mean(env.obj(bits)))


def _signed_graph():
    """BA_100 with a deterministic half of the edges flipped to weight -1
    (the G11/G12/G32-class +-1 Gset shape)."""
    g = graph_from_name("BA_100_ID2")
    edges = [
        (a, b, -1.0 if (a + b) % 2 else 1.0) for a, b, _ in g.to_edge_list()
    ]
    return Graph.from_edge_list(g.num_nodes, edges, name="BA_100_pm1")


def test_signed_packed_sweep_bit_exact_vs_twin():
    t, _, _ = _kernel_vs_twin(_signed_graph(), 128, 3, seed=10)
    assert t.has_neg and t.k_planes == 1


def test_signed_twin_equals_xla_sweep_at_zero_noise():
    g = _signed_graph()
    tables = WeightedSweepTables.build(g)
    B, N = 64, g.num_nodes
    bits = jax.random.bernoulli(jax.random.PRNGKey(12), 0.5, (B, N))
    zero = jnp.zeros((2 * N, B), jnp.int32)
    ref0 = mcpg_sweep_reference(zero, bits, tables, g, num_sweeps=2, noise_scale=0.0)
    data = SweepData.build(g)
    xt = degree_ordered_sweep(
        jax.random.PRNGKey(13), mcpg_init_values(bits), data, num_sweeps=2,
        noise_scale=0.0,
    )
    np.testing.assert_array_equal(np.asarray(ref0), np.asarray(xt[:, :N] > 0.5))


def test_fused_requires_gpu_unless_interpret(setup):
    g, tables = setup
    bits = jnp.zeros((8, g.num_nodes), bool)
    with pytest.raises(RuntimeError, match="GPU kernel"):
        mcpg_sweep_fused(jnp.int32(0), bits, tables)


def test_tables_shapes_at_g22_width():
    g = gnm_graph(num_nodes=2000, num_edges=19990, seed=22)
    t = WeightedSweepTables.build(g)
    assert t.masks.shape == (2, 2000, 64) and t.masks.dtype == jnp.int32
    assert t.k_planes == 1 and not t.has_neg
    # tables are a pytree with static plane counts: they ride through jit
    leaves, treedef = jax.tree_util.tree_flatten(t)
    assert len(leaves) == 4
    assert jax.tree_util.tree_unflatten(treedef, leaves).k_planes == 1
