"""Fused Metropolis-Hastings bit-flip sampler: a Pallas kernel for Hopper.

The MCPG hot loop (`metro_sampling`, reference `MCPG.py:88-118` /
`MCPG/sampling.py:68-90`) runs hundreds of sequential single-flip proposal
rounds per chain. The XLA `lax.scan` formulation
(`rlsolver_tpu.ops.sampling.metropolis_bitflip_scan`) rewrites the [B, N]
chain state in device memory every round. This kernel (Pallas through
Triton) gives each program a block of chains, holds their bit-packed words
(32 nodes per int32) in registers for ALL rounds, and writes them back once.

Per round, each chain draws one uint32 from the shared counter hash
(`ops/counter_rng.hash_u32(seed, chain, round)`): the high 16 bits pick the
node by fixed-point scaling `(hi * N) >> 16`, the low 16 bits are a u16
uniform. The chain flips that node iff `u16 < thr[cur_bit, node]`, with the
u16-scaled accept thresholds `p/(1-p)` (bit 0) and `(1-p)/p` (bit 1) loaded
directly from a table in device memory — `metro_sampling`'s accept rule
min(1, (1-q)/q). Site choice is state-independent, so the stationary
distribution is the Bernoulli(probs) product measure (tested).

Wide instances (N >= 2^15) pick the WORD uniformly, `(hi * W) >> 16`, and
the bit position from the low 5 bits, with u16 from a second draw.
Proposals that land on the last word's padding bits never accept.

`mh_sample_reference` is the XLA twin: the same draws and thresholds over
the unpacked [B, N] state, bit-exact against the kernel for any input.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from rlsolver_tpu.ops.counter_rng import hash_u32

WIDE_NODES = 1 << 15  # from here on the node is drawn as (word, bitpos)
MAX_NODES = 1 << 20  # keeps the wide draw's hi16 * num_words inside uint32


def require_gpu(interpret: bool, what: str) -> None:
    """The fused kernels run compiled only on a GPU. Interpret mode (the
    CPU tests) is reached only by asking for it."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            f"{what} is a GPU kernel; the default backend is "
            f"{jax.default_backend()!r}. Use the XLA path (sampler='budgeted', "
            "sweep_mode='sequential') or pass interpret=True."
        )


def pow2_words(n: int) -> int:
    """int32 words per packed row, padded to a power of two (Triton blocks)."""
    w = (n + 31) // 32
    return 1 << max(0, (w - 1).bit_length())


def kernel_block(wpad: int) -> Tuple[int, int]:
    """(chains per program, warps) for packed rows of `wpad` words: about
    512 state words per warp, at most 8 chains, so that G22-class batches
    (8192 chains of 64 words) make ~8 programs for each of 132 SMs. On an
    H100 at G22 widths, 8 chains and one warp were the fastest of the
    shapes tried (PERF.md)."""
    blk = max(1, min(8, 512 // wpad))
    num_warps = max(1, min(8, blk * wpad // 512))
    return blk, num_warps


# pack/unpack materialize an int32 [B', W, 32] temporary — 32x the packed
# size. At gset-preset chain counts (10^6 chains) that is > 8 GB, so both
# chunk the chain axis with lax.map to bound the temporary at ~0.5 GB.
_CODEC_CHUNK = 1 << 16


def _pad_rows(x: jax.Array, chunk: int) -> jax.Array:
    """Pad the leading axis up to a multiple of `chunk` (with zeros)."""
    pad = (-x.shape[0]) % chunk
    if pad:
        x = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
    return x


def pack_bits(bits: jax.Array) -> jax.Array:
    """bool [B, N] -> little-endian int32 bit-words [B, ceil(N/32)]."""
    b, n = bits.shape
    w = (n + 31) // 32
    weights = jnp.left_shift(jnp.int32(1), jnp.arange(32, dtype=jnp.int32))

    def one(x):  # [c, N] bool -> [c, w] int32
        x = jnp.pad(x.astype(jnp.int32), ((0, 0), (0, w * 32 - n)))
        return jnp.sum(x.reshape(-1, w, 32) * weights, axis=-1, dtype=jnp.int32)

    if b <= _CODEC_CHUNK:
        return one(bits)
    # pad B to a chunk multiple (then slice) so the lax.map body is always
    # a bounded [_CODEC_CHUNK, ...] block — never a per-row degenerate map
    # when B has no divisor <= the chunk (e.g. prime B).
    padded = _pad_rows(bits, _CODEC_CHUNK)
    out = jax.lax.map(one, padded.reshape(-1, _CODEC_CHUNK, n))
    return out.reshape(-1, w)[:b]


def unpack_bits(words: jax.Array, n: int) -> jax.Array:
    """int32 bit-words [B, W] -> bool [B, n] (inverse of `pack_bits`)."""
    b, w = words.shape
    shifts = jnp.arange(32, dtype=jnp.int32)

    def one(ws):  # [c, W] int32 -> [c, n] bool
        bits = jax.lax.shift_right_logical(ws[:, :, None], shifts[None, None, :]) & 1
        return bits.reshape(-1, w * 32)[:, :n].astype(bool)

    if b <= _CODEC_CHUNK:
        return one(words)
    padded = _pad_rows(words, _CODEC_CHUNK)
    out = jax.lax.map(one, padded.reshape(-1, _CODEC_CHUNK, w))
    return out.reshape(-1, n)[:b]


def pack_padded(bits: jax.Array, wpad: int, rows: int) -> jax.Array:
    """bool [B, N] -> int32 [rows, wpad] (zero words and zero chains)."""
    words = pack_bits(bits)
    return jnp.pad(
        words, ((0, rows - words.shape[0]), (0, wpad - words.shape[1]))
    )


def mh_proposal(seed, chain, step, num_nodes: int, num_words: int):
    """(node int32, u16 f32) of proposal `step` on `chain` — shared by the
    kernel and its twin. Nodes may reach the last word's padding bits only
    on the wide path."""
    if num_nodes < WIDE_NODES:
        h = hash_u32(seed, chain, step)
        node = ((h >> 16) * num_nodes) >> 16
        u16 = h & 0xFFFF
    else:
        h = hash_u32(seed, chain, 2 * step)
        node = (((h >> 16) * num_words) >> 16) * 32 + (h & 31)
        u16 = hash_u32(seed, chain, 2 * step + 1) & 0xFFFF
    return node.astype(jnp.int32), u16.astype(jnp.int32).astype(jnp.float32)


def mh_thresholds(probs: jax.Array, width: int) -> jax.Array:
    """f32 [2 * width]: u16-scaled accept thresholds given the current bit
    is 0 (first half) or 1 (second half); zero past the real nodes."""
    p = probs.astype(jnp.float32)
    t0 = jnp.clip(p / jnp.maximum(1.0 - p, 1e-9) * 65536.0, 0.0, 65536.0)
    t1 = jnp.clip((1.0 - p) / jnp.maximum(p, 1e-9) * 65536.0, 0.0, 65536.0)
    pad = (0, width - p.shape[0])
    return jnp.concatenate([jnp.pad(t0, pad), jnp.pad(t1, pad)])


def _mh_kernel(seed_ref, thr_ref, words_ref, out_ref, *, num_rounds, num_nodes,
               num_words, width):
    blk, wpad = words_ref.shape
    seed = seed_ref[0]
    chain = pl.program_id(0) * blk + jnp.arange(blk, dtype=jnp.int32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (blk, wpad), 1)

    def body(r, words):
        node, u16 = mh_proposal(seed, chain, r, num_nodes, num_words)
        bitpos = node & 31
        hot = lane == (node >> 5)[:, None]
        cur = (jnp.sum(jnp.where(hot, words, 0), axis=1) >> bitpos) & 1
        th = thr_ref[cur * width + node]
        flip = (u16 < th).astype(jnp.int32) << bitpos
        return words ^ jnp.where(hot, flip[:, None], 0)

    out_ref[...] = jax.lax.fori_loop(0, num_rounds, body, words_ref[...])


@functools.partial(
    jax.jit, static_argnames=("num_rounds", "interpret")
)
def mh_sample_fused(
    seed: jax.Array,
    probs: jax.Array,
    bits: jax.Array,
    num_rounds: int,
    interpret: bool = False,
) -> jax.Array:
    """`num_rounds` MH proposal rounds on every chain, in one kernel.

    seed: int32 scalar; probs: f32 [N]; bits: bool [B, N] (any B: chains are
    padded to the block). Returns bool [B, N], bit-exact vs
    `mh_sample_reference(seed, probs, bits, num_rounds)`."""
    require_gpu(interpret, "mh_sample_fused")
    b, n = bits.shape
    if n >= MAX_NODES:
        raise ValueError(f"fused sampler requires num_nodes < 2^20, got {n}")
    w = (n + 31) // 32
    wpad = pow2_words(n)
    blk, num_warps = kernel_block(wpad)
    rows = -(-b // blk) * blk
    width = wpad * 32
    out = pl.pallas_call(
        functools.partial(
            _mh_kernel, num_rounds=num_rounds, num_nodes=n, num_words=w,
            width=width,
        ),
        out_shape=jax.ShapeDtypeStruct((rows, wpad), jnp.int32),
        grid=(rows // blk,),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (0,)),
            pl.BlockSpec((2 * width,), lambda i: (0,)),
            pl.BlockSpec((blk, wpad), lambda i: (i, 0)),
        ],
        out_specs=pl.BlockSpec((blk, wpad), lambda i: (i, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="mh_sample_fused",
    )(
        jnp.reshape(seed, (1,)).astype(jnp.int32),
        mh_thresholds(probs, width),
        pack_padded(bits, wpad, rows),
    )
    return unpack_bits(out[:b, :w], n)


@functools.partial(jax.jit, static_argnames=("num_rounds",))
def mh_sample_reference(
    seed: jax.Array, probs: jax.Array, bits: jax.Array, num_rounds: int
) -> jax.Array:
    """XLA twin of `mh_sample_fused`: the same draws and thresholds on the
    unpacked state, one `lax.scan` step per round."""
    b, n = bits.shape
    w = (n + 31) // 32
    width = w * 32
    thr = mh_thresholds(probs, width)
    chain = jnp.arange(b, dtype=jnp.int32)
    seed = jnp.asarray(seed, jnp.int32)

    def body(x, r):
        node, u16 = mh_proposal(seed, chain, r, n, w)
        cur = x[chain, node]
        th = thr[cur.astype(jnp.int32) * width + node]
        return x.at[chain, node].set(cur ^ (u16 < th)), None

    x = jnp.pad(bits.astype(bool), ((0, 0), (0, width - n)))
    x, _ = jax.lax.scan(body, x, jnp.arange(num_rounds, dtype=jnp.int32))
    return x[:, :n]
