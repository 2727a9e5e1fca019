"""Variational quantum eigensolver baseline, pure-JAX statevector.

Reference counterpart: `rlsolver/methods/quantum.py:10-106` — maxcut/TSP
via qiskit SamplingVQE with a TwoLocal(ry, cz) ansatz and the SPSA
optimizer, demo-scale. qiskit is not a dependency here; the statevector
simulation IS the accelerator-friendly formulation: a TwoLocal(ry, cz) circuit on
|0..0> keeps every amplitude REAL (RY matrices are real, CZ is a +-1
diagonal), so the state is a [2^n] float32 tensor — no complex dtype on
the device — RY layers are batched 2x2 contractions,
CZ entanglers are sign masks, and any QUBO-style Hamiltonian is a diagonal
vector: one gather-free expectation per step, all inside jit.

Capability parity: TwoLocal(ry, cz, reps) ansatz, SPSA optimization,
maxcut-specific entry + generic diagonal-Hamiltonian entry. n <= ~16 qubits
(statevector is 2^n float32).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rlsolver_tpu.core.graph import Graph


def basis_bits(n: int) -> jnp.ndarray:
    """Bit table [2^n, n] int8: row x = binary of x (qubit 0 = LSB)."""
    codes = jnp.arange(2**n, dtype=jnp.uint32)
    return ((codes[:, None] >> jnp.arange(n, dtype=jnp.uint32)) & 1).astype(jnp.int8)


def maxcut_diagonal(graph: Graph) -> jnp.ndarray:
    """Cut value of every basis state, f32 [2^n] (diagonal Hamiltonian)."""
    bits = basis_bits(graph.num_nodes)
    e0, e1, w = graph.edge_arrays()
    diff = bits[:, e0] != bits[:, e1]
    return (diff * jnp.asarray(w)[None, :]).sum(axis=1).astype(jnp.float32)


def apply_ry_layer(state: jnp.ndarray, thetas: jnp.ndarray, n: int) -> jnp.ndarray:
    """Apply RY(theta_k) to every qubit k. state: [2^n] float32 (real)."""
    for k in range(n):
        st = state.reshape(2 ** (n - k - 1), 2, 2**k)
        c = jnp.cos(thetas[k] / 2.0)
        s = jnp.sin(thetas[k] / 2.0)
        a, b = st[:, 0, :], st[:, 1, :]
        st = jnp.stack([c * a - s * b, s * a + c * b], axis=1)
        state = st.reshape(-1)
    return state


def apply_cz_ring(state: jnp.ndarray, n: int, phase_mask: jnp.ndarray) -> jnp.ndarray:
    """CZ on the linear chain (k, k+1): precomputed -1 phase mask."""
    return state * phase_mask


def cz_chain_mask(n: int) -> jnp.ndarray:
    """(-1)^(#adjacent 11 pairs) over basis states (TwoLocal linear
    entanglement)."""
    bits = basis_bits(n).astype(jnp.int32)
    pairs = (bits[:, :-1] * bits[:, 1:]).sum(axis=1)
    return jnp.where(pairs % 2 == 0, 1.0, -1.0).astype(jnp.float32)


def two_local_state(params: jnp.ndarray, n: int, reps: int, cz_mask) -> jnp.ndarray:
    """TwoLocal(ry, cz, reps): reps+1 RY layers with CZ chains between."""
    state = jnp.zeros(2**n, jnp.float32).at[0].set(1.0)
    thetas = params.reshape(reps + 1, n)
    for r in range(reps):
        state = apply_ry_layer(state, thetas[r], n)
        state = apply_cz_ring(state, n, cz_mask)
    return apply_ry_layer(state, thetas[reps], n)


@dataclasses.dataclass
class VQEConfig:
    reps: int = 2
    num_iters: int = 300
    # SPSA schedule (standard Spall constants, as qiskit SPSA defaults)
    a: float = 0.2
    c: float = 0.2
    alpha: float = 0.602
    gamma: float = 0.101
    seed: int = 0


class VQEResult(Tuple):
    pass


def vqe_minimize_diagonal(
    diag: jnp.ndarray, num_qubits: int, cfg: VQEConfig = VQEConfig()
) -> Tuple[np.ndarray, float, list]:
    """SPSA-minimize <psi(theta)| diag |psi(theta)>.

    Returns (best basis bitstring [n], its diagonal value, energy history).
    """
    n = num_qubits
    cz_mask = cz_chain_mask(n)
    num_params = (cfg.reps + 1) * n

    @jax.jit
    def energy(params):
        state = two_local_state(params, n, cfg.reps, cz_mask)
        return jnp.dot(state * state, diag)

    @jax.jit
    def spsa_step(params, key, k):
        kf = k.astype(jnp.float32)
        ak = cfg.a / (kf + 1.0 + 10.0) ** cfg.alpha
        ck = cfg.c / (kf + 1.0) ** cfg.gamma
        delta = jnp.where(
            jax.random.bernoulli(key, 0.5, (num_params,)), 1.0, -1.0
        )
        e_plus = energy(params + ck * delta)
        e_minus = energy(params - ck * delta)
        ghat = (e_plus - e_minus) / (2.0 * ck) * delta
        return params - ak * ghat, (e_plus + e_minus) / 2.0

    key = jax.random.PRNGKey(cfg.seed)
    params = jax.random.uniform(key, (num_params,), minval=-0.1, maxval=0.1)
    history = []
    for it in range(cfg.num_iters):
        key, k = jax.random.split(key)
        params, e = spsa_step(params, k, jnp.int32(it))
        history.append(float(e))

    state = two_local_state(params, n, cfg.reps, cz_mask)
    probs = np.asarray(state) ** 2
    best = int(probs.argmax())
    bits = np.asarray((best >> np.arange(n)) & 1, np.int8)
    return bits, float(np.asarray(diag)[best]), history


def vqe_maxcut(
    graph: Graph, cfg: VQEConfig = VQEConfig()
) -> Tuple[np.ndarray, float, list]:
    """Maxcut via VQE (`quantum.py` capability): maximize the cut =
    minimize its negation. Returns (bits, cut value, energy history)."""
    if graph.num_nodes > 16:
        raise ValueError("statevector VQE limited to 16 qubits")
    diag = maxcut_diagonal(graph)
    bits, value, history = vqe_minimize_diagonal(-diag, graph.num_nodes, cfg)
    return bits, -value, [-h for h in history]
