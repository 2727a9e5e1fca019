"""MIMO maximum-likelihood detection as an Ising problem + linear baselines.

Reference counterparts:
  * `rlsolver/methods/MCPG/dataloader.py:297-430` (`read_data_mimo3/5`) —
    BPSK MIMO detection: real-valued 2K-dim decomposition, energy
    E(x) = x^T Sigma x + d.x + const with Sigma = H^T H (zero diagonal),
    d = -2 y^T H; minimizing E = minimizing ||y - Hx||^2;
  * `MCPG/sampling.py:288-323` (`mcpg_sampling_mimo`) — sequential
    coordinate sweep `x_i <- -sign(2 Sigma_i . x + d_i)`;
  * `methods_problem_specific/mimo_beamforming/.../baseline_zf_mmse.py` —
    zero-forcing and MMSE linear detectors (the classical baselines).

Accelerator-first: batched instance generation, vectorized energies, incremental
field sweeps, and batched ZF/MMSE via one solve each.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class MimoInstance:
    """Real-valued BPSK MIMO detection instance.

    h: [2M, 2K] real channel; y: [2M] received; x_true: [2K] +-1 sent;
    snr_db: per-symbol SNR; sigma2: real-noise variance per component.
    """

    h: np.ndarray
    y: np.ndarray
    x_true: np.ndarray
    snr_db: float
    sigma2: float

    @property
    def num_vars(self) -> int:
        return int(self.h.shape[1])


def generate_mimo(
    k: int, m: Optional[int] = None, snr_db: float = 10.0, seed: int = 0
) -> MimoInstance:
    """Random complex Gaussian channel, BPSK symbols, AWGN at `snr_db`
    (`read_data_mimo5` semantics: v scaled by sqrt(2K * 10^(-SNR/10)))."""
    m = m or k
    rng = np.random.RandomState(seed)
    hc = (rng.randn(m, k) + 1j * rng.randn(m, k)) / np.sqrt(2.0)
    h = np.block([[hc.real, -hc.imag], [hc.imag, hc.real]])  # [2M, 2K]
    x = rng.choice([-1.0, 1.0], size=2 * k)
    sigma2 = k * 10.0 ** (-snr_db / 10.0)
    v = rng.randn(2 * m) * np.sqrt(sigma2)
    y = h @ x + v
    return MimoInstance(h, y, x, snr_db, sigma2)


class MimoEnv:
    """Detection energy E(x) = ||y - Hx||^2 over x in {-1,+1}^{2K},
    expanded to x^T Sigma x + d.x + y.y with Sigma = H^T H (diag kept —
    constant for +-1 x, harmless)."""

    def __init__(self, inst: MimoInstance, dtype=jnp.float32):
        self.inst = inst
        self.num_vars = inst.num_vars
        sigma = inst.h.T @ inst.h
        self.sigma = jnp.asarray(sigma, dtype)
        self.sigma_offdiag = jnp.asarray(sigma - np.diag(np.diag(sigma)), dtype)
        self.d = jnp.asarray(-2.0 * inst.y @ inst.h, dtype)
        self.const = float(inst.y @ inst.y)
        self.h = jnp.asarray(inst.h, dtype)
        self.y = jnp.asarray(inst.y, dtype)

    def obj(self, spins: jax.Array) -> jax.Array:
        """Residual energy ||y - Hx||^2, f32 [B] (minimize)."""
        s = spins.astype(jnp.float32)
        r = self.y[None, :] - s @ self.h.T
        return jnp.sum(r * r, axis=1)

    def random_spins(self, key: jax.Array, num_chains: int) -> jax.Array:
        return jnp.where(
            jax.random.bernoulli(key, 0.5, (num_chains, self.num_vars)), 1.0, -1.0
        )

    def sweep(self, spins: jax.Array, num_sweeps: int = 1) -> jax.Array:
        """Coordinate descent `x_i <- -sign(2 (Sigma x)_i^{off} + d_i)`
        (`mcpg_sampling_mimo` inner loop), incremental field."""
        s = spins.astype(jnp.float32)
        h = s @ self.sigma_offdiag  # [B, N]

        def step(carry, i):
            s, h = carry
            field = 2.0 * h[:, i] + self.d[i]
            new = jnp.where(field < 0, 1.0, -1.0)
            delta = new - s[:, i]
            h = h + delta[:, None] * self.sigma_offdiag[i][None, :]
            s = s.at[:, i].set(new)
            return (s, h), None

        order = jnp.tile(jnp.arange(self.num_vars), num_sweeps)
        (s, _), _ = jax.lax.scan(step, (s, h), order)
        return s

    def bit_error_rate(self, spins: jax.Array) -> jax.Array:
        x = jnp.asarray(self.inst.x_true, jnp.float32)
        return jnp.mean(spins.astype(jnp.float32) != x[None, :], axis=1)


# ------------------------------------------------------------ linear baselines
def detect_zf(inst: MimoInstance) -> np.ndarray:
    """Zero-forcing: sign(pinv(H) y) (`baseline_zf_mmse.py` capability)."""
    xh = np.linalg.pinv(inst.h) @ inst.y
    return np.where(xh >= 0, 1.0, -1.0)


def detect_mmse(inst: MimoInstance) -> np.ndarray:
    """MMSE: sign((H^T H + sigma^2 I)^-1 H^T y)."""
    n = inst.num_vars
    a = inst.h.T @ inst.h + inst.sigma2 * np.eye(n)
    xh = np.linalg.solve(a, inst.h.T @ inst.y)
    return np.where(xh >= 0, 1.0, -1.0)


def detect_ml_brute(inst: MimoInstance) -> np.ndarray:
    """Exact ML by enumeration (2K <= 20), as one device computation."""
    n = inst.num_vars
    if n > 20:
        raise ValueError("brute-force ML limited to 2K <= 20")
    codes = jnp.arange(2**n, dtype=jnp.uint32)
    spins = jnp.where(
        ((codes[:, None] >> jnp.arange(n, dtype=jnp.uint32)) & 1) > 0, 1.0, -1.0
    )
    env = MimoEnv(inst)
    e = env.obj(spins)
    return np.asarray(spins[int(jnp.argmin(e))])
