"""GPU lane: the compiled Pallas kernels at full widths, on the card.

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu_kernels.py -m gpu -q

Every kernel output is compared bit for bit with its XLA twin, re-scored
against the host objective, or distribution-checked, mirroring the
reference's dual-implementation discipline (`rlsolver/envs/env_L2A.py:54/68`).
The tests skip where JAX's default backend is not a GPU (`gpu` fixture).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rlsolver_tpu.core.generate import gnm_graph
from rlsolver_tpu.ops.pallas.mcpg_sweep import (
    WeightedSweepTables,
    mcpg_sweep_fused,
    mcpg_sweep_reference,
    sweep_noise_grid,
)
from rlsolver_tpu.ops.pallas.mh_sampler import mh_sample_fused, mh_sample_reference

pytestmark = pytest.mark.gpu

CHAINS, MH_ROUNDS, SWEEPS = 8192, 400, 8  # chip_smoke.py's phase-2 widths


@pytest.fixture(scope="module", params=[False, True], ids=["unit", "pm1"])
def g22like(request):
    return gnm_graph(signed=request.param)


def test_mh_fused_bit_exact_at_g22_width(gpu):
    n = 2000
    key = jax.random.PRNGKey(0)
    probs = jax.random.uniform(key, (n,), minval=0.2, maxval=0.8)
    bits = jax.random.bernoulli(jax.random.fold_in(key, 1), 0.5, (CHAINS, n))
    out = mh_sample_fused(jnp.int32(7), probs, bits, MH_ROUNDS)
    ref = mh_sample_reference(jnp.int32(7), probs, bits, MH_ROUNDS)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_mh_fused_stationary_distribution(gpu):
    """Long-run per-site frequencies match the target Bernoulli product
    measure (chi-square-style tolerance over 2048 chains)."""
    n, chains, rounds = 256, 2048, 4096
    key = jax.random.PRNGKey(0)
    probs = jax.random.uniform(key, (n,), minval=0.2, maxval=0.8)
    bits = jax.random.bernoulli(jax.random.fold_in(key, 1), 0.5, (chains, n))
    out = mh_sample_fused(jnp.int32(7), probs, bits, rounds)
    freq = np.asarray(out.astype(jnp.float32).mean(axis=0))
    p = np.asarray(probs)
    err = np.abs(freq - p)
    assert err.mean() < 0.03 and err.max() < 0.15
    chi = ((freq - p) ** 2 * chains / (p * (1 - p))).mean()
    assert chi < 5.0


def test_sweep_fused_bit_exact_at_g22_width(gpu, g22like):
    t = WeightedSweepTables.build(g22like)
    bits = jax.random.bernoulli(jax.random.PRNGKey(1), 0.5, (CHAINS, 2000))
    out = mcpg_sweep_fused(jnp.int32(3), bits, t, num_sweeps=SWEEPS)
    noise = sweep_noise_grid(3, CHAINS, SWEEPS * 2000)
    ref = mcpg_sweep_reference(noise, bits, t, g22like, num_sweeps=SWEEPS)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_sweep_fused_improves_and_rescoring_matches(gpu, g22like):
    """Sweep outputs re-scored by the device objective (bf16 adjacency, f32
    accumulation) equal the host objective, and the sweep improves cuts."""
    from rlsolver_tpu.envs.maxcut import MaxcutEnv
    from rlsolver_tpu.problems.objectives import obj_maxcut

    env = MaxcutEnv(g22like)
    t = WeightedSweepTables.build(g22like)
    bits = jax.random.bernoulli(jax.random.PRNGKey(2), 0.5, (512, 2000))
    before = np.asarray(env.obj(bits))
    out = mcpg_sweep_fused(jnp.int32(5), bits, t, num_sweeps=4)
    after = np.asarray(env.obj(out))
    assert after.mean() > before.mean() + 100
    rows = np.asarray(out[:8])
    for i in range(8):
        assert after[i] == obj_maxcut(rows[i], g22like)


def test_weighted_sweep_three_planes_on_chip(gpu):
    """|w| <= 7 signed weights (3 bit-planes of each sign) at N = 2000."""
    from rlsolver_tpu.core.graph import Graph

    rng = np.random.default_rng(0)
    n, edges = 2000, []
    for i in range(n):
        for j in rng.choice(n, 10, replace=False):
            if i < j:
                w = int(rng.integers(1, 8)) * (1 if rng.random() < 0.7 else -1)
                edges.append((i, int(j), float(w)))
    g = Graph.from_edge_list(n, edges, name="W2000")
    t = WeightedSweepTables.build(g)
    assert t.k_planes == 3 and t.has_neg
    bits = jax.random.bernoulli(jax.random.PRNGKey(1), 0.5, (1024, n))
    out = mcpg_sweep_fused(jnp.int32(4), bits, t, num_sweeps=2)
    ref = mcpg_sweep_reference(sweep_noise_grid(4, 1024, 2 * n), bits, t, g, num_sweeps=2)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_mh_fused_wide_node_path_at_40k_nodes(gpu):
    """N > 32768 takes the (word, bitpos) draw. With probs = 1 every
    proposal to a real 0-bit flips it up and never down: after ~100 expected
    hits per node every node is reached, and per-node coverage is uniform;
    probs = 0 is the mirror image."""
    n, chains, rounds = 40000, 1024, 4096
    ones = jnp.ones((n,), jnp.float32)
    zeros_bits = jnp.zeros((chains, n), bool)
    hit = np.asarray(mh_sample_fused(jnp.int32(5), ones, zeros_bits, rounds))
    assert hit.any(axis=0).all()
    freq = hit.mean(axis=0)
    assert abs(freq.mean() - freq[: n // 2].mean()) < 0.02
    out0 = mh_sample_fused(jnp.int32(6), 1.0 - ones, ~zeros_bits, rounds)
    assert not np.asarray(out0).all(axis=0).any()
