"""MCPG's degree-ordered local-search sweep: one Pallas kernel for Hopper.

The sampler's inner loop (`sampler_func`, reference
`rlsolver/methods/MCPG.py:120-166`) visits nodes in descending-degree order
and sets x_i to the anti-majority of its neighbours' current values, with
the first sweep's mixed value domain: already-processed nodes contribute
their {0, 1} bit, unprocessed ones 2x - 0.5 in {-0.5, 1.5}
(`MCPG.py:131-141`). The XLA formulation
(`rlsolver_tpu.ops.sweeps.degree_ordered_sweep`) is a `lax.scan` of padded
neighbour gathers over a [B, N+1] f32 state: N * num_sweeps small kernels.

This kernel (Pallas through Triton) runs the whole sweep in one program per
block of chains, with the chains bit-packed (32 nodes per int32) in
registers. Integer weights are split into k signed bit-planes,
|w| = sum_b 2^b bit_b, so each weighted neighbour sum is a static sum of
popcounts,

    nbr_sum = sum_b 2^b (popcount(x & pos_b[k]) - popcount(x & neg_b[k])),

with unit weights one plane and {0, +-1} weights one plane of each sign.
One packed `earlier[k]` table (bit j set iff node j precedes step k in the
order) gives the first sweep's mixed domain: proc + 2*unproc =
2*pc_all - pc_proc, and thr1[k] = (wdeg + ns)/2 + 0.5 * U_k folds in the
-0.5 of the U_k unprocessed neighbours. Mask rows [WPAD] are read from
device memory at each node step; every chain of a program reads the same
row, so it is served from cache.

Noise is the shared counter hash, u16 = hash_u32(seed, chain, s*N + k), so
the kernel is bit-exact against its XLA twin `mcpg_sweep_reference` fed the
same draws (`sweep_noise`): every quantity compared is an exact integer or
half, plus u16 * ns / 65536, identically rounded on both sides.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.ops.counter_rng import hash_u32
from rlsolver_tpu.ops.pallas.mh_sampler import (
    kernel_block,
    pack_padded,
    pow2_words,
    require_gpu,
    unpack_bits,
)

MAX_ABS_WEIGHT = 1 << 15  # keeps every popcount sum far below 2^24 (exact f32)


def _integer_weights(graph: Graph) -> np.ndarray:
    adj = np.asarray(graph.adjacency_dense(), np.float64)
    iw = np.rint(adj)
    if not np.array_equal(adj, iw):
        raise ValueError("packed sweep requires integer edge weights")
    w_max = int(np.abs(iw).max()) if iw.size else 0
    if w_max >= MAX_ABS_WEIGHT:
        raise ValueError(f"|weight| must be < {MAX_ABS_WEIGHT}, got {w_max}")
    if w_max == 0:
        raise ValueError("graph has no edges")
    return iw.astype(np.int64)


def _pack_rows(rows: np.ndarray, wpad: int) -> np.ndarray:
    """bool [R, N] -> packed little-endian int32 [R, wpad]."""
    r, n = rows.shape
    padded = np.zeros((r, wpad * 32), bool)
    padded[:, :n] = rows
    weights = 1 << np.arange(32, dtype=np.int64)
    words = (padded.reshape(r, wpad, 32) * weights).sum(axis=2)
    return (words & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["nodes", "thr1", "thr2", "masks"],
    meta_fields=["k_planes", "has_neg"],
)
@dataclasses.dataclass(frozen=True)
class WeightedSweepTables:
    """Static per-instance tables for the sweep, rows in sweep
    (descending-degree) order. A pytree whose static fields (k_planes,
    has_neg) select the kernel body, so tables ride through jit as
    arguments. `mcpg_sweep_reference` reads only nodes/thr1/thr2."""

    nodes: jax.Array  # [N] int32 node ids (sweep order)
    thr1: jax.Array  # [N] f32 first-sweep thresholds (incl. +0.5 * U_k)
    thr2: jax.Array  # [N] f32 later-sweep thresholds
    # [1 + k (+ k), N, WPAD] int32: the earlier-in-order masks, then the
    # k positive bit-planes, then (signed graphs only) the k negative ones
    masks: jax.Array
    k_planes: int
    has_neg: bool

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def wpad(self) -> int:
        return self.masks.shape[2]

    @staticmethod
    def build(graph: Graph) -> "WeightedSweepTables":
        iw = _integer_weights(graph)
        n = graph.num_nodes
        order = np.asarray(graph.degree_sorted_nodes(descending=True))
        pos_of = np.empty(n, np.int64)
        pos_of[order] = np.arange(n)
        a_ord = iw[order]  # [N steps, N node ids]
        earlier = pos_of[None, :] < np.arange(n)[:, None]  # [N, N]
        u_cnt = (a_ord * ~earlier).sum(axis=1).astype(np.float64)
        wdeg = np.asarray(graph.weighted_degrees())[order].astype(np.float64)
        wpad = pow2_words(n)
        k = int(np.abs(a_ord).max()).bit_length()
        abs_w = np.abs(a_ord)
        planes = [earlier]
        signs = (1, -1) if (a_ord < 0).any() else (1,)
        for sign in signs:
            for b in range(k):
                planes.append((a_ord * sign > 0) & (((abs_w >> b) & 1) == 1))
        return WeightedSweepTables(
            nodes=jnp.asarray(order.astype(np.int32)),
            thr1=jnp.asarray((wdeg / 2.0 + 0.5 * u_cnt).astype(np.float32)),
            thr2=jnp.asarray((wdeg / 2.0).astype(np.float32)),
            masks=jnp.asarray(np.stack([_pack_rows(p, wpad) for p in planes])),
            k_planes=k,
            has_neg=len(signs) == 2,
        )


def sweep_noise(seed, chain, step) -> jax.Array:
    """int32 u16 noise of node step `step` (= sweep * N + k) on `chain`."""
    return (hash_u32(seed, chain, step) & 0xFFFF).astype(jnp.int32)


def _sweep_kernel(seed_ref, nodes_ref, thr1_ref, thr2_ref, masks_ref, words_ref,
                  out_ref, *, num_nodes, num_sweeps, noise_scale, k_planes,
                  has_neg):
    blk, wpad = words_ref.shape
    seed = seed_ref[0]
    chain = pl.program_id(0) * blk + jnp.arange(blk, dtype=jnp.int32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (blk, wpad), 1)
    scale = jnp.float32(noise_scale / 65536.0)
    half_ns = jnp.float32(noise_scale / 2.0)
    plane_signs = [(1 + b, 1, b) for b in range(k_planes)]
    if has_neg:
        plane_signs += [(1 + k_planes + b, -1, b) for b in range(k_planes)]

    def popcount(words, m):
        return jnp.sum(jax.lax.population_count(words & m[None, :]), axis=1)

    def update(words, step, k, first):
        e = masks_ref[0, k, :] if first else None
        nbr = jnp.zeros((blk,), jnp.int32)
        for p, sign, b in plane_signs:
            m = masks_ref[p, k, :]
            t = popcount(words, m)
            if first:  # proc + 2 * unproc = 2 * all - proc
                t = 2 * t - popcount(words, m & e)
            nbr = nbr + sign * (t << b)
        u = sweep_noise(seed, chain, step).astype(jnp.float32) * scale
        thr = (thr1_ref[k] if first else thr2_ref[k]) + half_ns
        new_bit = ((nbr.astype(jnp.float32) + u) < thr).astype(jnp.int32)
        node = nodes_ref[k]
        bitmask = jnp.left_shift(jnp.int32(1), node & 31)
        written = (words & ~bitmask) | (new_bit[:, None] * bitmask)
        return jnp.where(lane == (node >> 5), written, words)

    words = jax.lax.fori_loop(
        0, num_nodes, lambda k, w: update(w, k, k, True), words_ref[...]
    )
    words = jax.lax.fori_loop(
        num_nodes,
        num_sweeps * num_nodes,
        lambda sk, w: update(w, sk, jax.lax.rem(sk, num_nodes), False),
        words,
    )
    out_ref[...] = words


@functools.partial(
    jax.jit,
    static_argnames=("num_sweeps", "noise_scale", "interpret"),
)
def mcpg_sweep_fused(
    seed: jax.Array,
    bits: jax.Array,
    tables: WeightedSweepTables,
    num_sweeps: int = 1,
    noise_scale: float = 0.25,
    interpret: bool = False,
) -> jax.Array:
    """`num_sweeps` noisy degree-ordered sweeps over bool [B, N] chains
    (any B: chains are padded to the block). Bit-exact vs
    `mcpg_sweep_reference(sweep_noise grid, bits, tables, graph, ...)`."""
    require_gpu(interpret, "mcpg_sweep_fused")
    b, n = bits.shape
    if n != tables.num_nodes:
        raise ValueError(f"bits have {n} nodes, tables built for {tables.num_nodes}")
    wpad = tables.wpad
    blk, num_warps = kernel_block(wpad)
    rows = -(-b // blk) * blk
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)  # noqa: E731
    out = pl.pallas_call(
        functools.partial(
            _sweep_kernel,
            num_nodes=n,
            num_sweeps=num_sweeps,
            noise_scale=noise_scale,
            k_planes=tables.k_planes,
            has_neg=tables.has_neg,
        ),
        out_shape=jax.ShapeDtypeStruct((rows, wpad), jnp.int32),
        grid=(rows // blk,),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (0,)),
            whole(tables.nodes),
            whole(tables.thr1),
            whole(tables.thr2),
            whole(tables.masks),
            pl.BlockSpec((blk, wpad), lambda i: (i, 0)),
        ],
        out_specs=pl.BlockSpec((blk, wpad), lambda i: (i, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=2),
        interpret=interpret,
        name="mcpg_sweep_fused",
    )(
        jnp.reshape(seed, (1,)).astype(jnp.int32),
        tables.nodes,
        tables.thr1,
        tables.thr2,
        tables.masks,
        pack_padded(bits, wpad, rows),
    )
    return unpack_bits(out[:b, : (n + 31) // 32], n)


def sweep_noise_grid(seed, num_chains: int, num_steps: int) -> jax.Array:
    """int32 [num_steps, num_chains] u16 noise, as the kernel draws it."""
    step = jnp.arange(num_steps, dtype=jnp.int32)[:, None]
    chain = jnp.arange(num_chains, dtype=jnp.int32)[None, :]
    return sweep_noise(jnp.asarray(seed, jnp.int32), chain, step)


def mcpg_sweep_reference(
    noise_u16: jax.Array,
    bits: jax.Array,
    tables: WeightedSweepTables,
    graph: Graph,
    num_sweeps: int = 1,
    noise_scale: float = 0.25,
) -> jax.Array:
    """XLA twin mirroring the kernel's exact arithmetic, consuming injected
    u16 noise [num_sweeps * N, B] (`sweep_noise_grid` gives the kernel's).
    bits: bool [B, N] -> bool [B, N]."""
    n = tables.num_nodes
    adj = jnp.asarray(np.asarray(graph.adjacency_dense()), jnp.float32)  # [N, N]
    order = tables.nodes
    a_ord = adj[order]  # [N, N] in sweep order
    pos = jnp.zeros((n,), jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
    earlier = pos[None, :] < jnp.arange(n, dtype=jnp.int32)[:, None]
    m_proc = jnp.where(earlier, a_ord, 0.0)
    m_unproc = jnp.where(earlier, 0.0, a_ord)
    scale = jnp.float32(noise_scale / 65536.0)
    half_ns = jnp.float32(noise_scale / 2.0)
    hi = jax.lax.Precision.HIGHEST

    def step(x, inp):
        k, u, is_first = inp
        node = order[k]
        pc_p = jnp.matmul(x, m_proc[k], precision=hi)
        pc_u = jnp.matmul(x, m_unproc[k], precision=hi)
        pc_a = jnp.matmul(x, a_ord[k], precision=hi)
        nbr = jnp.where(is_first, pc_p + 2.0 * pc_u, pc_a)
        thr = jnp.where(is_first, tables.thr1[k], tables.thr2[k]) + half_ns
        u_term = u.astype(jnp.float32) * scale
        new_bit = ((nbr + u_term) < thr).astype(jnp.float32)
        return x.at[:, node].set(new_bit), None

    k_idx = jnp.tile(jnp.arange(n), num_sweeps)
    is_first = jnp.repeat(jnp.arange(num_sweeps), n) == 0
    x, _ = jax.lax.scan(step, bits.astype(jnp.float32), (k_idx, noise_u16, is_first))
    return x > 0
