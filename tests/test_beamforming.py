"""MIMO beamforming env, ZF/MMSE baselines, refinement-policy training.

Complex arithmetic is explicit (re, im) pairs (no complex dtype on the device);
host numpy complex is the test oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np

from rlsolver_tpu.problems.beamforming import (
    BeamformingSpec,
    BeamformingTrainConfig,
    CTensor,
    cmatmul,
    hpd_inverse,
    mmse_beamformer,
    normalize_power,
    random_channels,
    sum_rate,
    train_beamforming,
    zf_beamformer,
)


SPEC = BeamformingSpec(num_users=4, num_antennas=4, total_power=10.0)


def rand_complex(rng, shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)) / np.sqrt(2)


def test_cmatmul_matches_numpy():
    rng = np.random.RandomState(0)
    a = rand_complex(rng, (3, 4, 5))
    b = rand_complex(rng, (3, 5, 6))
    out = cmatmul(CTensor.from_numpy(a), CTensor.from_numpy(b), "bij,bjk->bik")
    np.testing.assert_allclose(out.to_numpy(), a @ b, atol=1e-5)


def test_hpd_inverse_matches_numpy():
    rng = np.random.RandomState(1)
    h = rand_complex(rng, (5, 4, 4))
    a = h @ h.conj().transpose(0, 2, 1) + 0.5 * np.eye(4)  # HPD
    inv = hpd_inverse(CTensor.from_numpy(a)).to_numpy()
    np.testing.assert_allclose(inv, np.linalg.inv(a), atol=1e-3)


def test_sum_rate_matches_host():
    rng = np.random.RandomState(2)
    h = rand_complex(rng, (3, 4, 4))
    w = rand_complex(rng, (3, 4, 4))
    dev = np.asarray(
        sum_rate(CTensor.from_numpy(h), CTensor.from_numpy(w), SPEC.noise_power)
    )
    for b in range(3):
        hw = h[b] @ w[b]
        sig = np.abs(np.diag(hw)) ** 2
        interf = (np.abs(hw) ** 2).sum(axis=1) - sig
        expect = np.log2(1 + sig / (interf + SPEC.noise_power)).sum()
        assert abs(dev[b] - expect) < 1e-3


def test_power_normalization():
    w = random_channels(jax.random.PRNGKey(2), SPEC, 5)
    wn = normalize_power(CTensor(w.re.transpose(0, 2, 1), w.im.transpose(0, 2, 1)), SPEC.total_power)
    p = np.asarray(jnp.sum(wn.abs2(), axis=(1, 2)))
    np.testing.assert_allclose(p, SPEC.total_power, rtol=1e-4)


def test_zf_nulls_interference():
    h = random_channels(jax.random.PRNGKey(3), SPEC, 4)
    w = zf_beamformer(h, SPEC)
    hw = cmatmul(h, w, "bkn,bnj->bkj").to_numpy()
    for b in range(4):
        off = hw[b] - np.diag(np.diag(hw[b]))
        assert np.abs(off).max() < 5e-2  # interference ~ 0


def test_mmse_beats_zf_at_low_snr():
    spec = BeamformingSpec(num_users=4, num_antennas=4, total_power=1.0, noise_power=1.0)
    h = random_channels(jax.random.PRNGKey(4), spec, 64)
    r_zf = float(sum_rate(h, zf_beamformer(h, spec), spec.noise_power).mean())
    r_mmse = float(sum_rate(h, mmse_beamformer(h, spec), spec.noise_power).mean())
    assert r_mmse >= r_zf - 1e-3


def test_relay_chain():
    from rlsolver_tpu.problems.beamforming import (
        RelaySpec,
        identity_relay,
        random_relay_channels,
        relay_effective_channel,
        relay_sum_rate,
    )

    spec = RelaySpec()
    g, h = random_relay_channels(jax.random.PRNGKey(6), spec, 16)
    f = identity_relay(spec, 16)
    # effective channel matches numpy composition
    heff = relay_effective_channel(h, f, g).to_numpy()
    expect = h.to_numpy() @ f.to_numpy() @ g.to_numpy()
    np.testing.assert_allclose(heff, expect, atol=1e-4)
    rates = np.asarray(relay_sum_rate(h, f, g, spec))
    assert rates.shape == (16,) and np.isfinite(rates).all() and (rates > 0).all()
    # a random amplification matrix also yields a finite positive rate
    f_rand = normalize_power(
        CTensor(
            jax.random.normal(jax.random.PRNGKey(7), f.re.shape),
            jax.random.normal(jax.random.PRNGKey(8), f.re.shape),
        ),
        spec.relay_power,
    )
    r_rand = np.asarray(relay_sum_rate(h, f_rand, g, spec))
    assert np.isfinite(r_rand).all() and (r_rand > 0).all()


def test_policy_training_beats_mmse_start():
    cfg = BeamformingTrainConfig(batch=64, episode_length=3, num_steps=60, lr=1e-3)
    policy, params, history = train_beamforming(SPEC, cfg)
    assert np.isfinite(history).all()
    assert np.mean(history[-10:]) > np.mean(history[:10]) - 0.2
    h = random_channels(jax.random.PRNGKey(5), SPEC, 128)
    w = mmse_beamformer(h, SPEC)
    for _ in range(3):
        w = policy.apply(params, h, w)
    r_policy = float(sum_rate(h, w, SPEC.noise_power).mean())
    r_mmse = float(sum_rate(h, mmse_beamformer(h, SPEC), SPEC.noise_power).mean())
    assert r_policy > r_mmse - 0.3
