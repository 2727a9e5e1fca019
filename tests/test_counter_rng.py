"""The counter hash that feeds the fused kernels and their twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rlsolver_tpu.ops.counter_rng import hash_u32, seed_from_key


def _grid(seed, chains=256, steps=256):
    c = jnp.arange(chains, dtype=jnp.int32)[:, None]
    s = jnp.arange(steps, dtype=jnp.int32)[None, :]
    return np.asarray(hash_u32(jnp.int32(seed), c, s))


def test_hash_is_deterministic_and_uint32():
    a, b = _grid(3), _grid(3)
    assert a.dtype == np.uint32
    np.testing.assert_array_equal(a, b)
    # scalar counters give the same draw as the broadcast grid
    assert int(hash_u32(3, 5, 7)) == int(a[5, 7])


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
def test_hash_seed_sensitivity(seed):
    a, b = _grid(seed), _grid(seed + 1 if seed < 2**31 - 1 else 0)
    assert (a != b).mean() > 0.999
    # neighbouring chains and steps differ too: no collapsed counter axis
    assert (a[1:] != a[:-1]).mean() > 0.999
    assert (a[:, 1:] != a[:, :-1]).mean() > 0.999


@pytest.mark.parametrize("shift", [0, 16, 27])
def test_hash_uniformity(shift):
    # 16 equal bins of a 4-bit field at low, middle and high positions
    x = (_grid(11) >> shift) & 15
    counts = np.bincount(x.ravel(), minlength=16)
    expected = x.size / 16
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < 45  # chi-square with 15 dof: p < 1e-4 above ~44


def test_hash_bit_balance():
    bits = (_grid(5)[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    frac = bits.reshape(-1, 32).mean(axis=0)
    assert np.abs(frac - 0.5).max() < 0.01


def test_seed_from_key():
    s = seed_from_key(jax.random.PRNGKey(0))
    assert s.dtype == jnp.int32 and s.shape == () and int(s) >= 0
    assert int(s) != int(seed_from_key(jax.random.PRNGKey(1)))
