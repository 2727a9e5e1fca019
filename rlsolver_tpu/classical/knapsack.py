"""Knapsack solver zoo.

Reference counterpart: `rlsolver/methods_problem_specific/knapsack/` —
brute force, branch & bound, dynamic programming, FPTAS, greedy, SA.

Accelerator-first redesign: the DP table sweep is a `lax.scan` over items with the
whole capacity axis as one vector op (the reference fills the table with
python loops); brute force enumerates all 2^n subsets as a batched device
computation; SA is a batched annealer over many chains. Branch & bound and
greedy stay host-side (sequential by nature).

All solvers return (bits [n] bool, value) with the feasibility convention of
`obj_knapsack` (`util_obj.py` capability): infeasible -> value counts only
what fits... we instead always return feasible solutions.
"""

from __future__ import annotations

import heapq
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rlsolver_tpu.core.io import KnapsackInstance


def _as_arrays(inst: KnapsackInstance):
    w = np.asarray(inst.weights, np.float64)
    p = np.asarray(inst.profits, np.float64)
    return w, p, float(inst.capacity)


def greedy_knapsack(inst: KnapsackInstance) -> Tuple[np.ndarray, float]:
    """Density-ordered greedy (`knapsack/greedy.py`)."""
    w, p, cap = _as_arrays(inst)
    order = np.argsort(-p / np.maximum(w, 1e-12))
    bits = np.zeros(len(w), bool)
    total = 0.0
    for i in order:
        if total + w[i] <= cap:
            bits[i] = True
            total += w[i]
    return bits, float(p[bits].sum())


def dp_knapsack(inst: KnapsackInstance) -> Tuple[np.ndarray, float]:
    """Exact DP over integer capacities (`knapsack/dynamic_programming.py`),
    as a jitted scan: one [cap+1] vector shift-max per item."""
    w, p, cap = _as_arrays(inst)
    cap = int(cap)
    wi = jnp.asarray(np.rint(w).astype(np.int32))
    pi = jnp.asarray(p, jnp.float32)
    c = jnp.arange(cap + 1)

    def scan_item(table, iw_ip):
        iw, ip = iw_ip
        shifted = jnp.where(
            c >= iw, jnp.roll(table, iw) + ip, -jnp.inf
        )  # take item (roll pads with wrapped junk, masked by c >= iw)
        new = jnp.maximum(table, shifted)
        return new, new

    init = jnp.zeros(cap + 1, jnp.float32)
    _, tables = jax.lax.scan(scan_item, init, (wi, pi))
    tables = np.asarray(jnp.concatenate([init[None], tables], axis=0))  # [n+1, cap+1]

    # backtrack on host
    n = len(w)
    bits = np.zeros(n, bool)
    ccur = cap
    for i in range(n - 1, -1, -1):
        if tables[i + 1, ccur] > tables[i, ccur] + 1e-9:
            bits[i] = True
            ccur -= int(np.rint(w[i]))
    return bits, float(p[bits].sum())


def fptas_knapsack(inst: KnapsackInstance, eps: float = 0.1) -> Tuple[np.ndarray, float]:
    """FPTAS (`knapsack/fptas.py`): scale profits to n/eps precision, DP over
    scaled-profit axis, pick the best feasible profit level."""
    w, p, cap = _as_arrays(inst)
    n = len(w)
    pmax = p.max(initial=0.0)
    if pmax <= 0:
        return np.zeros(n, bool), 0.0
    k = eps * pmax / n
    ps = np.floor(p / k).astype(np.int64)
    psum = int(ps.sum())
    # dp[v] = min weight achieving scaled profit v
    dp = np.full(psum + 1, np.inf)
    dp[0] = 0.0
    choice = np.zeros((n, psum + 1), bool)
    for i in range(n):
        take = np.full_like(dp, np.inf)
        take[ps[i] :] = dp[: psum + 1 - ps[i]] + w[i]
        better = take < dp
        choice[i] = better
        dp = np.where(better, take, dp)
    feasible = np.where(dp <= cap)[0]
    v = int(feasible.max())
    bits = np.zeros(n, bool)
    for i in range(n - 1, -1, -1):
        if choice[i, v]:
            bits[i] = True
            v -= ps[i]
    return bits, float(p[bits].sum())


def brute_force_knapsack(inst: KnapsackInstance) -> Tuple[np.ndarray, float]:
    """Exact enumeration of all 2^n subsets as one device computation
    (`knapsack/brute_force.py`); n <= 24."""
    w, p, cap = _as_arrays(inst)
    n = len(w)
    if n > 24:
        raise ValueError("brute force limited to n <= 24")
    codes = jnp.arange(2**n, dtype=jnp.uint32)
    bits = ((codes[:, None] >> jnp.arange(n, dtype=jnp.uint32)) & 1).astype(
        jnp.float32
    )
    tw = bits @ jnp.asarray(w, jnp.float32)
    tp = bits @ jnp.asarray(p, jnp.float32)
    tp = jnp.where(tw <= cap + 1e-9, tp, -jnp.inf)
    best = int(jnp.argmax(tp))
    sel = np.asarray((best >> np.arange(n)) & 1, bool)
    return sel, float(p[sel].sum())


def branch_and_bound_knapsack(inst: KnapsackInstance) -> Tuple[np.ndarray, float]:
    """Best-first branch & bound with the fractional relaxation bound
    (`knapsack/branch_and_bound.py`)."""
    w, p, cap = _as_arrays(inst)
    n = len(w)
    order = np.argsort(-p / np.maximum(w, 1e-12))
    ws, ps = w[order], p[order]

    def bound(i, profit, room):
        b = profit
        while i < n and ws[i] <= room:
            room -= ws[i]
            b += ps[i]
            i += 1
        if i < n and room > 0:
            b += ps[i] * room / ws[i]
        return b

    best_profit = 0.0
    best_sel = np.zeros(n, bool)
    # heap of (-bound, i, profit, room, chosen-tuple)
    heap = [(-bound(0, 0.0, cap), 0, 0.0, cap, ())]
    while heap:
        nb, i, profit, room, chosen = heapq.heappop(heap)
        if -nb <= best_profit + 1e-12:
            continue
        if i == n:
            continue
        # take item i
        if ws[i] <= room:
            np_, nr = profit + ps[i], room - ws[i]
            nc = chosen + (i,)
            if np_ > best_profit:
                best_profit = np_
                sel = np.zeros(n, bool)
                sel[list(nc)] = True
                best_sel = sel
            heapq.heappush(heap, (-bound(i + 1, np_, nr), i + 1, np_, nr, nc))
        # skip item i
        b = bound(i + 1, profit, room)
        if b > best_profit + 1e-12:
            heapq.heappush(heap, (-b, i + 1, profit, room, chosen))

    bits = np.zeros(n, bool)
    bits[order[best_sel]] = True
    return bits, float(best_profit)


def sa_knapsack(
    inst: KnapsackInstance,
    key: jax.Array,
    num_chains: int = 256,
    num_steps: int = 2000,
    t0: float = 1.0,
    t1: float = 0.01,
) -> Tuple[np.ndarray, float]:
    """Batched simulated annealing (`knapsack/simulated_annealing.py`):
    many chains of single-item flips, infeasible moves rejected, geometric
    temperature schedule — all one jitted scan."""
    w, p, cap = _as_arrays(inst)
    n = len(w)
    wj = jnp.asarray(w, jnp.float32)
    pj = jnp.asarray(p, jnp.float32)

    k_init, k_run = jax.random.split(key)
    bits = jnp.zeros((num_chains, n), bool)
    weight = jnp.zeros(num_chains, jnp.float32)
    value = jnp.zeros(num_chains, jnp.float32)
    temps = jnp.asarray(
        t0 * (t1 / t0) ** (np.arange(num_steps) / max(1, num_steps - 1)), jnp.float32
    ) * float(p.max(initial=1.0))

    def step(carry, inp):
        bits, weight, value, best_bits, best_value = carry
        k, temp = inp
        k1, k2 = jax.random.split(k)
        idx = jax.random.randint(k1, (num_chains,), 0, n)
        cur = jnp.take_along_axis(bits, idx[:, None], axis=1)[:, 0]
        dw = jnp.where(cur, -wj[idx], wj[idx])
        dv = jnp.where(cur, -pj[idx], pj[idx])
        feasible = weight + dw <= cap + 1e-9
        accept_prob = jnp.exp(jnp.minimum(dv / jnp.maximum(temp, 1e-9), 0.0))
        accept = feasible & (jax.random.uniform(k2, (num_chains,)) < accept_prob)
        bits = jnp.where(
            accept[:, None] & (jnp.arange(n)[None, :] == idx[:, None]), ~bits, bits
        )
        weight = jnp.where(accept, weight + dw, weight)
        value = jnp.where(accept, value + dv, value)
        improved = value > best_value
        best_bits = jnp.where(improved[:, None], bits, best_bits)
        best_value = jnp.where(improved, value, best_value)
        return (bits, weight, value, best_bits, best_value), None

    keys = jax.random.split(k_run, num_steps)
    (bits, weight, value, best_bits, best_value), _ = jax.lax.scan(
        step, (bits, weight, value, bits, value), (keys, temps)
    )
    b = int(jnp.argmax(best_value))
    sel = np.asarray(best_bits[b])
    return sel, float(p[sel].sum())
