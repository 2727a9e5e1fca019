"""MPNN / policy nets and mesh-sharded rollout tests (8 virtual CPU devices)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rlsolver_tpu.envs.maxcut import MaxcutEnv
from rlsolver_tpu.models.mpnn import MPNN
from rlsolver_tpu.models.policy import BernoulliPolicy
from rlsolver_tpu.models.policy_mlp import PolicyMLP
from rlsolver_tpu.parallel import mesh as mesh_lib


def test_mpnn_shapes_and_grad(small_graphs):
    g = small_graphs["BA_32"]
    adj = jnp.asarray(g.adjacency_dense())
    model = MPNN(features=32, n_layers=2)
    obs = jax.random.normal(jax.random.PRNGKey(0), (4, g.num_nodes, 7))
    params = model.init(jax.random.PRNGKey(1), obs, adj)
    q = model.apply(params, obs, adj)
    assert q.shape == (4, g.num_nodes)
    assert q.dtype == jnp.float32

    def loss(p):
        return jnp.sum(model.apply(p, obs, adj) ** 2)

    grads = jax.grad(loss)(params)
    leaves = jax.tree.leaves(grads)
    assert all(jnp.isfinite(l).all() for l in leaves)
    assert any(float(jnp.abs(l).max()) > 0 for l in leaves)


def test_mpnn_batched_adjacency(small_graphs):
    g = small_graphs["BA_32"]
    adj = jnp.asarray(g.adjacency_dense())
    model = MPNN(features=16, n_layers=1)
    obs = jax.random.normal(jax.random.PRNGKey(0), (3, g.num_nodes, 7))
    params = model.init(jax.random.PRNGKey(1), obs, adj)
    q_shared = model.apply(params, obs, adj)
    q_batched = model.apply(params, obs, jnp.tile(adj[None], (3, 1, 1)))
    np.testing.assert_allclose(
        np.asarray(q_shared), np.asarray(q_batched), rtol=1e-5, atol=1e-6
    )


def test_bernoulli_policy_squash():
    pol = BernoulliPolicy(10)
    params = pol.init(jax.random.PRNGKey(0))
    probs = np.asarray(pol.apply(params))
    assert probs.shape == (10,)
    np.testing.assert_allclose(probs, 0.5, atol=1e-6)  # zero logits -> 0.5
    assert (probs > 0.2).all() and (probs < 0.8).all()


def test_policy_mlp():
    pol = PolicyMLP(12, hidden=(16,))
    p0 = jnp.full((5, 12), 0.5)
    params = pol.init(jax.random.PRNGKey(0), p0)
    out = pol.apply(params, p0)
    assert out.shape == (5, 12)
    assert ((out > 0) & (out < 1)).all()


def test_mesh_has_8_devices():
    m = mesh_lib.make_mesh()
    assert m.devices.size == 8


def test_sharded_rollout_matches_single_device(small_graphs):
    """local_search sharded over the env axis == unsharded result."""
    g = small_graphs["BA_32"]
    env = MaxcutEnv(g)
    m = mesh_lib.make_mesh()
    num_sims = 64

    def per_shard(keys, xs):
        # keys: [shard_B, 2] per-sim fold-in keys (deterministic per sim)
        vs = env.obj(xs)
        xs2, vs2 = env.sweep_1flip(xs, vs)
        total_best = jax.lax.pmax(jnp.max(vs2), mesh_lib.ENV_AXIS)
        return xs2, vs2, jnp.broadcast_to(total_best, (xs.shape[0],))

    xs = env.random_xs(jax.random.PRNGKey(0), num_sims)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(7), i))(
        jnp.arange(num_sims)
    )
    sharded = mesh_lib.shard_rollout(m, per_shard)
    xs_in = mesh_lib.shard_env_batch(m, xs)
    keys_in = mesh_lib.shard_env_batch(m, keys)
    xs_s, vs_s, best_s = sharded(keys_in, xs_in)

    vs_ref = env.obj(xs)
    xs_u, vs_u = env.sweep_1flip(xs, vs_ref)
    np.testing.assert_allclose(np.asarray(vs_s), np.asarray(vs_u))
    np.testing.assert_array_equal(np.asarray(xs_s), np.asarray(xs_u))
    assert float(best_s[0]) == float(jnp.max(vs_u))


def test_chunked_mha_exact_vs_full():
    """Query-chunked attention is exact: a tiny score budget (forcing many
    chunks) must reproduce the single-pass result bit-for-bit-ish."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rlsolver_tpu.models.transformer import ChunkedMHA

    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (3, 50, 32))
    full = ChunkedMHA(num_heads=4, score_budget=1 << 30)
    tiny = ChunkedMHA(num_heads=4, score_budget=4 * 3 * 4 * 7 * 50)  # qc=7
    params = full.init(key, x, x)
    np.testing.assert_allclose(
        np.asarray(full.apply(params, x, x)),
        np.asarray(tiny.apply(params, x, x)),
        rtol=2e-5, atol=2e-5,
    )


def test_policy_trs_runs_with_chunked_attention():
    import jax
    import jax.numpy as jnp

    from rlsolver_tpu.models.transformer import PolicyTrsWithValue

    net = PolicyTrsWithValue(embed_dim=32, num_heads=4)
    key = jax.random.PRNGKey(1)
    xs = jax.random.bernoulli(key, 0.5, (4, 40))
    seq = jax.random.normal(key, (40, 32))
    params = net.init(key, jnp.zeros((1, 40, 2)), seq)
    probs = net.apply(params, xs, seq, method=PolicyTrsWithValue.probs)
    assert probs.shape == (4, 40) and bool(jnp.all((probs >= 0) & (probs <= 1)))


def test_chunked_mha_grad_exact_and_checkpointed():
    """Gradients through the chunked path equal the single-pass gradients
    (jax.checkpoint recomputes chunk scores instead of stacking residuals)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rlsolver_tpu.models.transformer import ChunkedMHA

    key = jax.random.PRNGKey(2)
    x = jax.random.normal(key, (2, 40, 16))
    full = ChunkedMHA(num_heads=2, score_budget=1 << 30)
    tiny = ChunkedMHA(num_heads=2, score_budget=4 * 2 * 2 * 5 * 40)
    params = full.init(key, x, x)

    def loss(m, p):
        return jnp.sum(m.apply(p, x, x) ** 2)

    gf = jax.grad(lambda p: loss(full, p))(params)
    gt = jax.grad(lambda p: loss(tiny, p))(params)
    for a, b in zip(jax.tree.leaves(gf), jax.tree.leaves(gt)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-4)
