"""MIMO beamforming (sum-rate precoder optimization) + baselines.

Reference counterpart:
`rlsolver/methods_problem_specific/mimo_beamforming/` —
`mimo_beamforming_env/env_mimo.py` (`MIMOEnv`: batched complex channels
H [B, K, N] drawn from a growing random subspace (curriculum,
`generate_channel_batch`), reward = sum rate sum_k log2(1 + SINR_k),
MMSE-initialized precoder refined over `episode_length` steps),
`baseline_zf_mmse.py` / `baseline_mmse.py` (ZF and MMSE precoders and the
classical WMMSE iteration), `net_mimo.py` + `train_reinforce_mimo.py`
(policy net refining W, trained by direct gradient ascent on the
differentiable sum rate; podracer variant = vectorized multi-env batch).

Accelerator-first: the device program uses neither complex dtypes nor
LAPACK-style linalg custom calls: complex tensors are explicit (re, im)
pairs (`CTensor`) whose products are real matmuls, and the Hermitian
positive-definite inverses in ZF/MMSE use a Newton-Schulz iteration —
matmul-only, quadratically convergent for the regularized Gram matrices
used here. The whole refinement episode is a `lax.scan`; training loss =
-sum_rate backprops through the episode.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax


class CTensor(NamedTuple):
    """Complex tensor as a (re, im) pair of f32 arrays."""

    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    def conj(self) -> "CTensor":
        return CTensor(self.re, -self.im)

    def abs2(self) -> jax.Array:
        return self.re**2 + self.im**2

    def transpose(self, *axes) -> "CTensor":
        return CTensor(jnp.transpose(self.re, axes), jnp.transpose(self.im, axes))

    def __add__(self, o: "CTensor") -> "CTensor":
        return CTensor(self.re + o.re, self.im + o.im)

    def scale(self, s: jax.Array) -> "CTensor":
        return CTensor(self.re * s, self.im * s)

    @staticmethod
    def from_numpy(z: np.ndarray) -> "CTensor":
        return CTensor(jnp.asarray(z.real, jnp.float32), jnp.asarray(z.imag, jnp.float32))

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.re) + 1j * np.asarray(self.im)


def cmatmul(a: CTensor, b: CTensor, spec: str) -> CTensor:
    """einsum over a complex pair: (ar + i ai)(br + i bi)."""
    re = jnp.einsum(spec, a.re, b.re) - jnp.einsum(spec, a.im, b.im)
    im = jnp.einsum(spec, a.re, b.im) + jnp.einsum(spec, a.im, b.re)
    return CTensor(re, im)


def ceye(n: int, batch_shape=()) -> CTensor:
    eye = jnp.broadcast_to(jnp.eye(n), batch_shape + (n, n))
    return CTensor(eye, jnp.zeros_like(eye))


def hpd_inverse(a: CTensor, num_iters: int = 24) -> CTensor:
    """Inverse of a batched Hermitian positive-definite complex matrix via
    Newton-Schulz: X <- X (2I - A X). Matmul-only (no LAPACK custom call).

    Converges when ||I - A X0|| < 1; X0 = A^H / (||A||_1 ||A||_inf) is the
    standard safe initialization (Pan & Schreiber).
    """
    n = a.shape[-1]
    ah = CTensor(
        jnp.swapaxes(a.re, -1, -2), -jnp.swapaxes(a.im, -1, -2)
    )
    mag = jnp.sqrt(a.abs2())
    norm1 = jnp.max(jnp.sum(mag, axis=-2), axis=-1)  # max col sum
    norminf = jnp.max(jnp.sum(mag, axis=-1), axis=-1)  # max row sum
    scale = (1.0 / (norm1 * norminf))[..., None, None]
    x = CTensor(ah.re * scale, ah.im * scale)
    two_i = ceye(n, a.shape[:-2])

    def body(x, _):
        ax = cmatmul(a, x, "...ij,...jk->...ik")
        r = CTensor(2.0 * two_i.re - ax.re, -ax.im)
        return cmatmul(x, r, "...ij,...jk->...ik"), None

    x, _ = jax.lax.scan(body, x, None, length=num_iters)
    return x


@dataclasses.dataclass(frozen=True)
class BeamformingSpec:
    num_users: int = 4  # K
    num_antennas: int = 4  # N
    total_power: float = 10.0
    noise_power: float = 1.0


def random_channels(key: jax.Array, spec: BeamformingSpec, batch: int) -> CTensor:
    """H [B, K, N] complex pair, unit-average-power Rayleigh."""
    k, n = spec.num_users, spec.num_antennas
    kr, ki = jax.random.split(key)
    s = 1.0 / np.sqrt(2.0)
    return CTensor(
        jax.random.normal(kr, (batch, k, n)) * s,
        jax.random.normal(ki, (batch, k, n)) * s,
    )


def sum_rate(h: CTensor, w: CTensor, noise_power: float = 1.0) -> jax.Array:
    """Downlink sum rate, f32 [B]. h: [B, K, N]; w: [B, N, K].
    Matches `MIMOEnv.get_reward` (`env_mimo.py:49-56`)."""
    hw = cmatmul(h, w, "bkn,bnj->bkj")  # [B, K, K]
    p = hw.abs2()
    sig = jnp.diagonal(p, axis1=1, axis2=2)
    interf = jnp.sum(p, axis=2) - sig
    sinr = sig / (interf + noise_power)
    return jnp.sum(jnp.log2(1.0 + sinr), axis=1)


def normalize_power(w: CTensor, total_power: float) -> CTensor:
    p = jnp.sum(w.abs2(), axis=(1, 2), keepdims=True)
    s = jnp.sqrt(total_power / jnp.maximum(p, 1e-12))
    return CTensor(w.re * s, w.im * s)


def zf_beamformer(h: CTensor, spec: BeamformingSpec) -> CTensor:
    """Zero-forcing: W = H^H (H H^H)^-1, power-normalized
    (`baseline_zf_mmse.py` capability)."""
    hh = cmatmul(h, h.conj(), "bkn,bjn->bkj")  # H H^H [B, K, K]
    reg = ceye(spec.num_users, (h.shape[0],))
    hh = CTensor(hh.re + 1e-4 * reg.re, hh.im)
    inv = hpd_inverse(hh)
    w = cmatmul(h.conj(), inv, "bkn,bkj->bnj")  # H^H inv
    return normalize_power(w, spec.total_power)


def mmse_beamformer(h: CTensor, spec: BeamformingSpec) -> CTensor:
    """MMSE/RZF: W = (H^H H + K sigma^2 / P I)^-1 H^H, power-normalized
    (`baseline_mmse.py:compute_mmse_beamformer`)."""
    n = spec.num_antennas
    reg = spec.num_users * spec.noise_power / spec.total_power
    gram = cmatmul(h.conj(), h, "bkn,bkm->bnm")
    a = CTensor(gram.re + reg * jnp.eye(n)[None], gram.im)
    inv = hpd_inverse(a)
    w = cmatmul(inv, h.conj(), "bnm,bkm->bnk")
    return normalize_power(w, spec.total_power)


class PrecoderPolicy(nn.Module):
    """Refinement policy: (H, W) -> residual update to W
    (`net_mimo.py:Policy_Net_MIMO` capability, MLP form)."""

    spec: BeamformingSpec
    hidden: int = 256

    @nn.compact
    def __call__(self, h: CTensor, w: CTensor) -> CTensor:
        b = h.shape[0]
        feat = jnp.concatenate(
            [
                h.re.reshape(b, -1),
                h.im.reshape(b, -1),
                w.re.reshape(b, -1),
                w.im.reshape(b, -1),
            ],
            axis=1,
        )
        x = nn.relu(nn.Dense(self.hidden)(feat))
        x = nn.relu(nn.Dense(self.hidden)(x))
        nk = self.spec.num_antennas * self.spec.num_users
        out = nn.Dense(2 * nk)(x) * 0.1
        shape = (b, self.spec.num_antennas, self.spec.num_users)
        delta = CTensor(out[:, :nk].reshape(shape), out[:, nk:].reshape(shape))
        return normalize_power(w + delta, self.spec.total_power)


# ------------------------------------------------------------------- relay
@dataclasses.dataclass(frozen=True)
class RelaySpec:
    """Two-hop downlink: BS (N antennas) -> relay (M antennas) -> K users.
    (`env_mimo_relay.py:MIMORelayEnv` capability)."""

    num_users: int = 2
    num_bs_antennas: int = 2
    num_relay_antennas: int = 2
    total_power: float = 10.0
    relay_power: float = 10.0
    noise_power: float = 1.0


def random_relay_channels(key: jax.Array, spec: RelaySpec, batch: int):
    """(g [B, M, N] BS->relay, h [B, K, M] relay->users)."""
    kg, kh = jax.random.split(key)
    s = 1.0 / np.sqrt(2.0)
    g = CTensor(
        jax.random.normal(kg, (batch, spec.num_relay_antennas, spec.num_bs_antennas)) * s,
        jax.random.normal(
            jax.random.fold_in(kg, 1),
            (batch, spec.num_relay_antennas, spec.num_bs_antennas),
        ) * s,
    )
    h = CTensor(
        jax.random.normal(kh, (batch, spec.num_users, spec.num_relay_antennas)) * s,
        jax.random.normal(
            jax.random.fold_in(kh, 1),
            (batch, spec.num_users, spec.num_relay_antennas),
        ) * s,
    )
    return g, h


def relay_effective_channel(h: CTensor, f: CTensor, g: CTensor) -> CTensor:
    """H_eff = H F G [B, K, N] (`env_mimo_relay.py:43` mat_HTFG)."""
    fg = cmatmul(f, g, "bij,bjk->bik")  # [B, M, N]
    return cmatmul(h, fg, "bij,bjk->bik")


def relay_sum_rate(
    h: CTensor, f: CTensor, g: CTensor, spec: RelaySpec
) -> jax.Array:
    """Sum rate of the two-hop link with the MMSE BS beamformer computed on
    the effective channel (`compute_mmse_beamformer_relay` flow)."""
    heff = relay_effective_channel(h, f, g)
    bs_spec = BeamformingSpec(
        num_users=spec.num_users,
        num_antennas=spec.num_bs_antennas,
        total_power=spec.total_power,
        noise_power=spec.noise_power,
    )
    w = mmse_beamformer(heff, bs_spec)
    return sum_rate(heff, w, spec.noise_power)


def identity_relay(spec: RelaySpec, batch: int) -> CTensor:
    """Power-normalized identity amplification baseline."""
    m = spec.num_relay_antennas
    f = CTensor(
        jnp.broadcast_to(jnp.eye(m), (batch, m, m)),
        jnp.zeros((batch, m, m)),
    )
    return normalize_power(f, spec.relay_power)


@dataclasses.dataclass
class BeamformingTrainConfig:
    batch: int = 256
    episode_length: int = 6
    num_steps: int = 300
    lr: float = 1e-3
    curriculum_start: int = 2  # growing-subspace curriculum dimension
    seed: int = 0


def train_beamforming(
    spec: BeamformingSpec = BeamformingSpec(),
    cfg: BeamformingTrainConfig = BeamformingTrainConfig(),
):
    """Direct-gradient training of the refinement policy through the
    episode scan (`train_reinforce_mimo.py` semantics), with the growing-
    subspace curriculum (`generate_channel_batch` `env_mimo.py:43-47`).
    Returns (policy, params, history)."""
    policy = PrecoderPolicy(spec)
    key = jax.random.PRNGKey(cfg.seed)
    k_init, key = jax.random.split(key)
    full = 2 * spec.num_users * spec.num_antennas
    # static orthonormal curriculum basis (host-side QR; no device linalg)
    basis = np.linalg.qr(np.random.RandomState(cfg.seed).rand(full, full))[0]
    basis = jnp.asarray(basis, jnp.float32)
    h0 = random_channels(k_init, spec, 1)
    params = policy.init(k_init, h0, mmse_beamformer(h0, spec))
    opt = optax.adam(cfg.lr)
    opt_state = opt.init(params)

    kn = spec.num_users * spec.num_antennas

    def curriculum_channels(k_h, dim):
        """`dim`-dimensional subspace channels via coordinate masking
        (static shapes; dim is a traced scalar)."""
        coords = jax.random.normal(k_h, (cfg.batch, full))
        coords = coords * (jnp.arange(full) < dim)
        vec = coords @ basis * jnp.sqrt(full / jnp.maximum(dim, 1))
        vec = vec / jnp.linalg.norm(vec, axis=1, keepdims=True) * np.sqrt(kn)
        shape = (cfg.batch, spec.num_users, spec.num_antennas)
        return CTensor(vec[:, :kn].reshape(shape), vec[:, kn:].reshape(shape))

    @jax.jit
    def step(params, opt_state, key, subspace_dim):
        key, k_h = jax.random.split(key)
        h_full = random_channels(k_h, spec, cfg.batch)
        h_cur = curriculum_channels(k_h, subspace_dim)
        use_full = subspace_dim >= full
        h = CTensor(
            jnp.where(use_full, h_full.re, h_cur.re),
            jnp.where(use_full, h_full.im, h_cur.im),
        )

        def loss_fn(p):
            def body(w, _):
                w = policy.apply(p, h, w)
                return w, sum_rate(h, w, spec.noise_power)

            w0 = mmse_beamformer(h, spec)
            _, rates = jax.lax.scan(body, w0, None, length=cfg.episode_length)
            return -jnp.mean(rates[-1]), rates[-1]

        (loss, rates), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, key, -loss

    history = []
    subspace_dim = cfg.curriculum_start
    for it in range(cfg.num_steps):
        params, opt_state, key, mean_rate = step(
            params, opt_state, key, jnp.int32(subspace_dim)
        )
        history.append(float(mean_rate))
        if (it + 1) % max(1, cfg.num_steps // full) == 0:
            subspace_dim = min(subspace_dim + 1, full)
    return policy, params, history
