"""Certified spectral (Poljak-Rendl / SDP-strength) maxcut upper bound.

Reference counterpart: the "obj bound" column of the benchmark tables is
produced by Gurobi's QUBO dual bound under a time limit
(`rlsolver/methods/gurobi.py:331-336`, `rlsolver/methods/config.py:78-83`,
tables at `rlsolver/docs/source/Benchmark/Benchmark.rst:38-55`). No MILP
license exists here, so this module provides the license-free equivalent:
the Poljak-Rendl eigenvalue bound, whose optimum equals the basic SDP
relaxation value (Poljak & Rendl 1995) and is typically a few percent
above the optimum on sparse random graphs — far tighter than a
time-limited MILP LP-relaxation dual.

Math. For x in {-1, +1}^n, cut(x) = (1/4) x^T L x with L = D_w - A_w the
weighted Laplacian. For ANY correcting vector u in R^n,
x^T diag(u) x = sum(u), so

    cut(x) = (1/4) x^T (L + diag(u)) x - (1/4) sum(u)
           <= (n/4) lambda_max(L + diag(u)) - (1/4) sum(u).

The bound is minimized over u by subgradient descent: the subgradient of
lambda_max at u is v v^T's diagonal = v_i^2 (v the top unit eigenvector),
so  d(bound)/du_i = (n/4) v_i^2 - 1/4.  Everything on the accelerator is
matmul + elementwise (power iteration), so it needs no LAPACK eigensolver
on the device.

Certification. Power iteration approaches lambda_max FROM BELOW, so the
descent objective is not itself a valid bound. The returned bound is
certified on the host in float64 by the trace-power inequality

    lambda_max(M') <= trace(M'^{2k})^{1/(2k)}        (M' = M + cI psd)

computed by repeated squaring with Frobenius normalization (overflow-safe
log-scale bookkeeping); the slack factor is at most n^{1/(2k)} — under
0.5% for k = 2^10 (10 squarings). The Gershgorin shift c makes M' psd so
that trace powers see lambda_max rather than max |lambda|.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rlsolver_tpu.core.graph import Graph


@dataclasses.dataclass
class SpectralBoundConfig:
    opt_iters: int = 1500  # smoothed-subgradient steps on u
    block_size: int = 16  # Ritz subspace width (eigenvalue multiplicity)
    power_iters: int = 3  # block-power multiplies between Rayleigh-Ritz
    lr: float = 2.0  # base step size (scaled by 1/sqrt decay)
    mu0: float = 1.0  # initial smoothing temperature (halved on schedule)
    mu_halvings: int = 6
    certify_squarings: int = 10  # k = 2^squarings trace power
    seed: int = 0


def _laplacian(graph: Graph) -> np.ndarray:
    a = graph.adjacency_dense(dtype=np.float64)
    return np.diag(a.sum(axis=1)) - a


def certify_lambda_max(m: np.ndarray, squarings: int = 10) -> float:
    """Rigorous float64 upper bound on lambda_max(m) for symmetric m via
    the trace-power inequality with Gershgorin PSD shift."""
    n = m.shape[0]
    diag = np.diag(m)
    offsum = np.abs(m).sum(axis=1) - np.abs(diag)
    lam_min_lower = float(np.min(diag - offsum))  # Gershgorin
    c = max(0.0, -lam_min_lower)
    mp = m + c * np.eye(n)
    # repeated squaring with log-scale normalization:
    # track  M_true^k = exp(a) * mk  with ||mk||_F == 1
    s = float(np.linalg.norm(mp))
    if s == 0.0:
        return -c
    mk = mp / s
    a = np.log(s)
    k = 1
    for _ in range(squarings):
        mk = mk @ mk
        k *= 2
        s = float(np.linalg.norm(mk))
        mk /= s
        a = 2.0 * a + np.log(s)
    # trace(M_true^{2k}) = ||M_true^k||_F^2 = exp(2a)  (||mk||_F == 1)
    # lambda_max(M') <= trace(M'^{2k})^{1/(2k)} = exp(a / k)
    # inflate by the accumulated matmul rounding (n*eps per squaring)
    fudge = 1.0 + 4.0 * n * np.finfo(np.float64).eps * squarings
    return float(np.exp(a / k)) * fudge - c


def maxcut_upper_bound(
    graph: Graph,
    cfg: SpectralBoundConfig = SpectralBoundConfig(),
    record=None,
) -> Tuple[float, dict]:
    """Returns (certified upper bound on maxcut, info dict).

    Optimizer: Nesterov-smoothed subgradient descent on
    f(u) = (n/4) lambda_max(L + diag(u)) - sum(u)/4. At the PR optimum the
    top eigenvalue is multiple, so a single-vector subgradient crawls; the
    smoothed gradient uses the top `block_size` Ritz pairs with softmax
    weights exp(lambda_j / mu) and anneals mu. Device work is matmul-only
    (block power iteration, no device LAPACK); the k x k Rayleigh-Ritz
    eigenproblem runs on the host in float64.

    info carries the uncertified (Ritz) estimate, the trivial u=0 bound,
    and the final u for reproducibility."""
    n = graph.num_nodes
    lap64 = _laplacian(graph)
    lap = jnp.asarray(lap64, jnp.float32)
    scale = float(np.abs(np.diag(lap64)).mean()) or 1.0
    k = min(cfg.block_size, n)

    @jax.jit
    def block_power(u, v_block, lap):
        # lap as a jit argument: [N, N] closure constants blow up the IR.
        # Shift by the Gershgorin lower bound on lambda_min so the
        # algebraically largest eigenvalues dominate the block power.
        m = lap + jnp.diag(u)
        diag = jnp.diag(m)
        offsum = jnp.sum(jnp.abs(m), axis=1) - jnp.abs(diag)
        shift = jnp.maximum(0.0, -jnp.min(diag - offsum)) + 1e-3 * scale

        def body(v, _):
            w = m @ v + shift * v
            w = w / (jnp.linalg.norm(w, axis=0, keepdims=True) + 1e-30)
            return w, None

        v_block, _ = jax.lax.scan(body, v_block, None, length=cfg.power_iters)
        return v_block

    rng = np.random.default_rng(cfg.seed)
    v_block = jnp.asarray(rng.normal(size=(n, k)), jnp.float32)
    u = jnp.zeros((n,), jnp.float32)

    mu = cfg.mu0 * scale * 0.25
    halve_every = max(1, cfg.opt_iters // (cfg.mu_halvings + 1))
    est = np.inf
    # Adam state on the host (u is tiny)
    m1 = np.zeros(n)
    m2 = np.zeros(n)
    u_np = np.zeros(n)
    for i in range(cfg.opt_iters):
        v_block = block_power(u, v_block, lap)
        # host Rayleigh-Ritz in float64 (k x k eigh is LAPACK-on-CPU only)
        vb = np.asarray(v_block, np.float64)
        q, _ = np.linalg.qr(vb)
        mq = lap64 @ q + u_np[:, None] * q  # (L + diag(u)) q without [N,N]
        t = q.T @ mq
        lam, y = np.linalg.eigh((t + t.T) / 2.0)
        z = q @ y  # Ritz vectors [n, k]
        w = np.exp((lam - lam[-1]) / mu)
        w /= w.sum()
        grad = (n / 4.0) * (z**2 @ w) - 0.25
        # plain SGD with 1/sqrt decay converges to the PR optimum here;
        # Adam's per-coordinate scaling measurably stalls it (tested on
        # BA_100_ID0: SGD 298.2 vs Adam 306.4 certified)
        lr = cfg.lr / np.sqrt(1.0 + i / 20.0)
        u_np = u_np - lr * grad
        u = jnp.asarray(u_np, jnp.float32)
        v_block = jnp.asarray(q, jnp.float32)
        est = (n / 4.0) * lam[-1] - u_np.sum() / 4.0
        if record is not None:
            record(i, est)
        if (i + 1) % halve_every == 0:
            mu *= 0.5

    cert = certified_bound(lap64, u_np, cfg.certify_squarings)
    best_cert, best_u = cert, u_np
    # u = 0 fallback (never worse than the trivial spectral bound)
    cert0 = certified_bound(lap64, np.zeros(n), cfg.certify_squarings)
    if cert0 < best_cert:
        best_cert, best_u = cert0, np.zeros(n)
    info = {
        "estimate": est,
        "trivial_bound": cert0,
        "u": best_u,
    }
    return float(best_cert), info


def certified_bound(lap64: np.ndarray, u: np.ndarray, squarings: int) -> float:
    """Certified maxcut bound for a given correcting vector u (float64)."""
    n = lap64.shape[0]
    m = lap64 + np.diag(u)
    lam = certify_lambda_max(m, squarings)
    return (n / 4.0) * lam - float(u.sum()) / 4.0


def maxcut_upper_bound_cell(
    graphs,
    cfg: SpectralBoundConfig = SpectralBoundConfig(),
) -> list:
    """Certified PR bounds for a whole same-size cell as ONE batched
    program: the block power iteration runs vmapped over the stacked
    [G, N, N] Laplacians (one device dispatch per optimizer iteration for
    ALL instances instead of one per instance — the per-instance variant
    is dispatch-latency-bound at ~3 dispatches/iter), the k x k host
    Rayleigh-Ritz loops over instances (trivial), and the final
    certification runs per instance in float64 on the host exactly as in
    `maxcut_upper_bound`. Returns a list of certified bounds.

    Reference counterpart: the per-instance Gurobi-QUBO dual bound runs
    feeding the "obj bound" column (`gurobi.py:331-336`).
    """
    g_cnt = len(graphs)
    n = graphs[0].num_nodes
    k = min(cfg.block_size, n)
    laps64 = [_laplacian(g) for g in graphs]
    laps = jnp.asarray(np.stack(laps64), jnp.float32)
    scales = np.array(
        [float(np.abs(np.diag(l)).mean()) or 1.0 for l in laps64]
    )
    scale = jnp.asarray(scales, jnp.float32)

    # Device phase A: block power iterations + the Gram/projection
    # matrices for a host-side Cholesky-QR Rayleigh-Ritz. Only [k, k]
    # matrices leave the device.
    @jax.jit
    def power_and_project(u, v_block, laps):
        def one(u_g, v_g, lap_g, scale_g):
            m = lap_g + jnp.diag(u_g)
            diag = jnp.diag(m)
            offsum = jnp.sum(jnp.abs(m), axis=1) - jnp.abs(diag)
            shift = jnp.maximum(0.0, -jnp.min(diag - offsum)) + 1e-3 * scale_g

            def body(v, _):
                w = m @ v + shift * v
                w = w / (jnp.linalg.norm(w, axis=0, keepdims=True) + 1e-30)
                return w, None

            v_g, _ = jax.lax.scan(body, v_g, None, length=cfg.power_iters)
            mv = m @ v_g  # note: includes diag(u); shift NOT included
            s = v_g.T @ v_g  # [k, k] Gram
            t0 = v_g.T @ mv  # [k, k] projected operator
            return v_g, s, t0

        return jax.vmap(one)(u, v_block, laps, scale)

    # Device phase B: apply the host-computed combination matrices —
    # orthonormalize v (v @ c), form Ritz directions, take the smoothed
    # subgradient step on u. p columns are sqrt(softmax)-weighted Ritz
    # vectors so that rowsum((v p)^2) = sum_j w_j z_j^2.
    @jax.jit
    def apply_update(u, v_block, c, p, lr):
        def one(u_g, v_g, c_g, p_g):
            z_w = v_g @ p_g  # [n, k]
            grad = (n / 4.0) * jnp.sum(z_w * z_w, axis=1) - 0.25
            return u_g - lr * grad, v_g @ c_g

        return jax.vmap(one)(u, v_block, c, p)

    rng = np.random.default_rng(cfg.seed)
    v_block = jnp.asarray(rng.normal(size=(g_cnt, n, k)), jnp.float32)
    u = jnp.zeros((g_cnt, n), jnp.float32)
    mus = scales * cfg.mu0 * 0.25
    halve_every = max(1, cfg.opt_iters // (cfg.mu_halvings + 1))
    eye = np.eye(k)

    for i in range(cfg.opt_iters):
        v_block, s_all, t_all = power_and_project(u, v_block, laps)
        s_np = np.asarray(s_all, np.float64)
        t_np = np.asarray(t_all, np.float64)
        cs = np.empty((g_cnt, k, k))
        ps = np.empty((g_cnt, k, k))
        collapsed = []
        for g in range(g_cnt):
            # Cholesky QR: v q_r = v c with c = chol(S)^-T (upper-tri solve)
            s_g = s_np[g] + 1e-10 * np.trace(s_np[g]) / k * eye
            try:
                r = np.linalg.cholesky(s_g).T  # S = R^T R
                c = np.linalg.solve(r, eye)  # R^-1 (v @ c orthonormal)
            except np.linalg.LinAlgError:
                # power collapse: fall back to the raw (non-orthonormal)
                # block for this iteration and queue a fresh random block
                # below so the Rayleigh-Ritz basis recovers next iteration
                # (certification soundness never depends on this step)
                c = eye.copy()
                collapsed.append(g)
            t = c.T @ t_np[g] @ c
            lam, y = np.linalg.eigh((t + t.T) / 2.0)
            w = np.exp((lam - lam[-1]) / mus[g])
            w /= w.sum()
            cs[g] = c
            ps[g] = c @ (y * np.sqrt(w)[None, :])
        lr = cfg.lr / np.sqrt(1.0 + i / 20.0)
        if collapsed:  # re-randomize collapsed blocks, keep u
            fresh = rng.normal(size=(len(collapsed), n, k))
            v_block = v_block.at[np.asarray(collapsed)].set(
                jnp.asarray(fresh, jnp.float32)
            )
        u, v_block = apply_update(
            u,
            v_block,
            jnp.asarray(cs, jnp.float32),
            jnp.asarray(ps, jnp.float32),
            jnp.float32(lr),
        )
        if (i + 1) % halve_every == 0:
            mus *= 0.5

    u_np = np.asarray(u, np.float64)
    out = []
    for g in range(g_cnt):
        # certified for ANY u — no u=0 fallback here (it is looser whenever
        # the optimization made progress, and the [N,N] float64 trace-power
        # is the dominant host cost at N >= 2000)
        out.append(certified_bound(laps64[g], u_np[g], cfg.certify_squarings))
    return out
