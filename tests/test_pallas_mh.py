"""Fused MH sampler (Pallas, Triton route): bit-exact parity with its XLA
twin in interpret mode, distributional correctness, and the packed codec."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rlsolver_tpu.ops.pallas.mh_sampler import (
    WIDE_NODES,
    kernel_block,
    mh_proposal,
    mh_sample_fused,
    mh_sample_reference,
    pack_bits,
    pow2_words,
    unpack_bits,
)


def _inputs(n, b, seed=0):
    key = jax.random.PRNGKey(seed)
    probs = jax.random.uniform(jax.random.fold_in(key, 1), (n,), minval=0.1, maxval=0.9)
    bits = jax.random.bernoulli(jax.random.fold_in(key, 2), 0.5, (b, n))
    return probs, bits


@pytest.mark.parametrize(
    "n,b,rounds",
    [
        (14, 16, 64),  # one word; chains a multiple of the block
        (14, 13, 64),  # chains not a multiple of the block
        (24, 256, 64),
        (71, 100, 128),  # a partial last block of chains
        (97, 512, 96),
        (100, 33, 48),  # several words, bitpos = 31 edge
        (1000, 8, 24),  # N not a multiple of 32
        (1000, 11, 24),
    ],
)
def test_fused_bit_exact_vs_xla_twin(n, b, rounds):
    probs, bits = _inputs(n, b, seed=n + b)
    out = mh_sample_fused(jnp.int32(5), probs, bits, rounds, interpret=True)
    ref = mh_sample_reference(jnp.int32(5), probs, bits, rounds)
    assert out.shape == (b, n) and out.dtype == jnp.bool_
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    assert (np.asarray(out) != np.asarray(bits)).any()  # the chains moved


def test_pallas_mh_stationary_distribution():
    # single-site MH with accept (1-q)/q, q = P(current value), satisfies
    # detailed balance for pi(1) = p: the kernel samples toward the policy
    probs = jnp.asarray([0.3, 0.5, 0.7, 0.4, 0.6, 0.5, 0.2, 0.8])
    bits = jax.random.bernoulli(jax.random.PRNGKey(3), 0.5, (512, 8))
    out = mh_sample_fused(jnp.int32(4), probs, bits, 384, interpret=True)
    np.testing.assert_allclose(
        np.asarray(out).mean(axis=0), np.asarray(probs), atol=0.06
    )


def test_stream_stationary_distribution():
    # u16-quantized accept thresholds + fixed-point site pick still target
    # Bernoulli(probs): site choice is state-independent
    probs = jnp.asarray([0.3, 0.5, 0.7, 0.4, 0.6, 0.5, 0.2, 0.8])
    bits = jax.random.bernoulli(jax.random.PRNGKey(3), 0.5, (2048, 8))
    out = mh_sample_reference(jnp.int32(4), probs, bits, 512)
    np.testing.assert_allclose(
        np.asarray(out).mean(axis=0), np.asarray(probs), atol=0.05
    )


def test_determinism_and_seed_sensitivity():
    probs = jnp.full((16,), 0.5)
    bits = jax.random.bernoulli(jax.random.PRNGKey(6), 0.5, (128, 16))
    a = mh_sample_fused(jnp.int32(7), probs, bits, 32, interpret=True)
    b = mh_sample_fused(jnp.int32(7), probs, bits, 32, interpret=True)
    c = mh_sample_fused(jnp.int32(8), probs, bits, 32, interpret=True)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (np.asarray(a) != np.asarray(c)).any()


def test_wide_node_addressing():
    """N >= 2^15 draws (word, bitpos): bit-exact vs the twin, proposals reach
    nodes above 2^15, and padding bits never flip on."""
    n, b, rounds = 40_000, 8, 48
    assert n >= WIDE_NODES
    ones = jnp.ones((n,), jnp.float32)  # every proposal on a 0-bit accepts
    zeros = jnp.zeros((b, n), bool)
    out = mh_sample_fused(jnp.int32(5), ones, zeros, rounds, interpret=True)
    ref = mh_sample_reference(jnp.int32(5), ones, zeros, rounds)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    hit = np.nonzero(np.asarray(out))[1]
    assert hit.size > 0.9 * b * rounds  # almost no proposal is lost
    assert (hit >= WIDE_NODES).any() and (hit < WIDE_NODES).any()
    w = (n + 31) // 32
    node, _ = mh_proposal(
        jnp.int32(5), jnp.arange(4096, dtype=jnp.int32)[:, None],
        jnp.arange(16, dtype=jnp.int32)[None, :], n, w,
    )
    node = np.asarray(node)
    assert node.min() >= 0 and node.max() < w * 32


@pytest.mark.parametrize("n", [14, 1000, 2000])
def test_proposals_in_range_and_uniform(n):
    node, u16 = mh_proposal(
        jnp.int32(3), jnp.arange(256, dtype=jnp.int32)[:, None],
        jnp.arange(256, dtype=jnp.int32)[None, :], n, (n + 31) // 32,
    )
    node, u16 = np.asarray(node), np.asarray(u16)
    assert node.min() >= 0 and node.max() < n
    assert u16.min() >= 0 and u16.max() < 65536
    counts = np.bincount(node.ravel(), minlength=n)
    expected = node.size / n
    assert np.abs(counts - expected).max() < 6 * np.sqrt(expected) + 2


def test_fused_requires_gpu_unless_interpret():
    probs, bits = _inputs(14, 8)
    with pytest.raises(RuntimeError, match="GPU kernel"):
        mh_sample_fused(jnp.int32(0), probs, bits, 4)


def test_kernel_block_shapes():
    assert pow2_words(14) == 1 and pow2_words(2000) == 64 and pow2_words(2049) == 128
    for wpad in (1, 64, 512, 2048):
        blk, warps = kernel_block(wpad)
        assert blk >= 1 and 1 <= warps <= 8
        assert blk & (blk - 1) == 0  # power of two (Triton block)
    assert kernel_block(64) == (8, 1)


def test_pack_unpack_roundtrip():
    for n in (1, 31, 32, 33, 300, 2000):
        bits = jax.random.bernoulli(jax.random.PRNGKey(n), 0.5, (16, n))
        words = pack_bits(bits)
        assert words.shape == (16, (n + 31) // 32)
        np.testing.assert_array_equal(np.asarray(unpack_bits(words, n)), np.asarray(bits))


def test_pack_unpack_chunked_nondivisor_batch(monkeypatch):
    # Batch sizes with no divisor <= the codec chunk (e.g. prime B just
    # above it) must pad to a chunk multiple, not degrade to per-row maps.
    from rlsolver_tpu.ops.pallas import mh_sampler as mh

    monkeypatch.setattr(mh, "_CODEC_CHUNK", 8)
    for b in (11, 13, 17):  # primes > chunk
        bits = jax.random.bernoulli(jax.random.PRNGKey(b), 0.5, (b, 70))
        words = mh.pack_bits(bits)
        assert words.shape == (b, 3)
        np.testing.assert_array_equal(
            np.asarray(mh.unpack_bits(words, 70)), np.asarray(bits)
        )
