"""Deep compressed sensing + ISTA/LISTA sparse recovery.

Reference counterpart:
`rlsolver/methods_problem_specific/compressive_sensing/` — deep compressed
sensing per Wu et al. 2019 (`readme.md`): a generator G_theta(z) is trained
jointly with a (possibly learned) measurement operator F_phi and a learned
step size; recovery runs a few latent gradient steps z <- z - eta *
grad_z ||F G(z) - y||^2 (`nn_dcs.py:122-` `train_dcs`, `Step_size`
`nn_dcs.py:99-106`), with an alternative policy-network latent update
("+ NN" row). The MATLAB LASSO baselines (`test_LeastR.m`) map to the
ISTA/FISTA iterations here.

Accelerator-first: the inner latent-optimization loop is a `lax.scan` with
`jax.grad` through the generator (cheap second-order-free unrolling);
training vmaps over a batch of signals; synthetic sparse signals replace
the MNIST pipeline (no dataset dependency).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax


# ------------------------------------------------------------ classic ISTA
def ista(
    f: jax.Array, y: jax.Array, lam: float = 0.05, num_iters: int = 200
) -> jax.Array:
    """Batched ISTA for min ||F x - y||^2/2 + lam ||x||_1.

    f: [M, N]; y: [B, M]. Returns x [B, N]. Step = 1/L with L = ||F||_2^2
    (power iteration).
    """
    v = jnp.ones((f.shape[1],))
    for _ in range(20):
        v = f.T @ (f @ v)
        v = v / jnp.linalg.norm(v)
    lip = jnp.linalg.norm(f @ v) ** 2
    step = 1.0 / lip

    def soft(x, t):
        return jnp.sign(x) * jnp.maximum(jnp.abs(x) - t, 0.0)

    def body(x, _):
        grad = (x @ f.T - y) @ f
        return soft(x - step * grad, step * lam), None

    x0 = jnp.zeros((y.shape[0], f.shape[1]))
    x, _ = jax.lax.scan(body, x0, None, length=num_iters)
    return x


class Lista(nn.Module):
    """Learned ISTA: T unrolled iterations with learned W/S/thresholds."""

    num_measure: int
    signal_dim: int
    num_layers: int = 8

    @nn.compact
    def __call__(self, y: jax.Array) -> jax.Array:
        def near_identity(key, shape, dtype=jnp.float32):
            return jnp.eye(shape[0], dtype=dtype) * 0.9 + jax.random.normal(
                key, shape, dtype
            ) * 0.01

        w = self.param(
            "w",
            nn.initializers.lecun_normal(),
            (self.num_measure, self.signal_dim),
        )
        x = y @ w
        for t in range(self.num_layers):
            s = self.param(f"s{t}", near_identity, (self.signal_dim, self.signal_dim))
            # softplus(-3) ~= 0.049: start with a small soft threshold
            theta = self.param(f"theta{t}", nn.initializers.constant(-3.0), ())
            h = y @ w + x @ s
            x = jnp.sign(h) * jnp.maximum(jnp.abs(h) - jax.nn.softplus(theta), 0.0)
        return x


# ------------------------------------------------------------------- DCS
class Generator(nn.Module):
    """z -> signal MLP (`nn_dcs.py:48-61`)."""

    out_dim: int
    mid_dim: int = 256

    @nn.compact
    def __call__(self, z):
        h = nn.relu(nn.Dense(self.mid_dim)(z))
        h = nn.relu(nn.Dense(self.mid_dim)(h))
        return nn.Dense(self.out_dim)(h)


@dataclasses.dataclass
class DCSConfig:
    signal_dim: int = 64
    latent_dim: int = 16
    num_measure: int = 24
    sparsity: int = 6
    num_grad_iters: int = 5  # latent steps (`num_grad_iters` nn_dcs.py:122)
    lr: float = 1e-3
    num_epochs: int = 300
    batch_size: int = 64
    learn_f: bool = True  # reparameterized measurement F_phi
    seed: int = 0


def sparse_signals(key: jax.Array, batch: int, dim: int, sparsity: int) -> jax.Array:
    """Synthetic k-sparse Gaussian signals."""
    k_pos, k_val = jax.random.split(key)
    scores = jax.random.uniform(k_pos, (batch, dim))
    thresh = jnp.sort(scores, axis=1)[:, sparsity - 1][:, None]
    mask = scores <= thresh
    vals = jax.random.normal(k_val, (batch, dim))
    return vals * mask


class DCS:
    """Joint training of G_theta, (optionally) F_phi, and the step size."""

    def __init__(self, cfg: DCSConfig = DCSConfig()):
        self.cfg = cfg
        self.gen = Generator(cfg.signal_dim)
        key = jax.random.PRNGKey(cfg.seed)
        k_g, k_f, self.key = jax.random.split(key, 3)
        g_params = self.gen.init(k_g, jnp.zeros((1, cfg.latent_dim)))
        f0 = jax.random.normal(k_f, (cfg.num_measure, cfg.signal_dim)) / np.sqrt(
            cfg.num_measure
        )
        self.params = {
            "gen": g_params,
            "f": f0,
            "log_step": jnp.asarray(np.log(0.01), jnp.float32),
        }
        self.opt = optax.adam(cfg.lr)
        self.opt_state = self.opt.init(self.params)

    def _recover_latent(self, params, y, z0):
        """`num_grad_iters` latent gradient steps (the "+ grad" path)."""
        step = jnp.exp(params["log_step"])
        f = params["f"]

        def meas_loss(z):
            xhat = self.gen.apply(params["gen"], z)
            return jnp.sum((xhat @ f.T - y) ** 2)

        def body(z, _):
            return z - step * jax.grad(meas_loss)(z), None

        z, _ = jax.lax.scan(body, z0, None, length=self.cfg.num_grad_iters)
        return z

    def reconstruct(self, params, y, z0):
        z = self._recover_latent(params, y, z0)
        return self.gen.apply(params["gen"], z)

    def train(self):
        cfg = self.cfg

        @jax.jit
        def step(params, opt_state, key):
            k_sig, k_z, key = jax.random.split(key, 3)
            x = sparse_signals(k_sig, cfg.batch_size, cfg.signal_dim, cfg.sparsity)
            z0 = jax.random.normal(k_z, (cfg.batch_size, cfg.latent_dim))

            def loss_fn(p):
                y = x @ p["f"].T
                xhat = self.reconstruct(p, y, z0)
                return jnp.mean(jnp.sum((xhat - x) ** 2, axis=1))

            loss, grads = jax.value_and_grad(loss_fn)(params)
            if not cfg.learn_f:
                grads = {**grads, "f": jnp.zeros_like(grads["f"])}
            updates, opt_state = self.opt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, key, loss

        history = []
        for _ in range(cfg.num_epochs):
            self.params, self.opt_state, self.key, loss = step(
                self.params, self.opt_state, self.key
            )
            history.append(float(loss))
        return history

    def recovery_error(self, num_eval: int = 128) -> float:
        """Mean ||x - xhat||_2 on fresh signals (the readme metric)."""
        cfg = self.cfg
        k_sig, k_z = jax.random.split(jax.random.fold_in(self.key, 999))
        x = sparse_signals(k_sig, num_eval, cfg.signal_dim, cfg.sparsity)
        z0 = jax.random.normal(k_z, (num_eval, cfg.latent_dim))
        y = x @ self.params["f"].T
        xhat = self.reconstruct(self.params, y, z0)
        return float(jnp.mean(jnp.linalg.norm(xhat - x, axis=1)))
