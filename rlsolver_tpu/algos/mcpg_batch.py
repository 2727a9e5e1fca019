"""Batched multi-instance MCPG: solve G same-size graphs in one SPMD program.

The reference solves one instance per process (`rlsolver/methods/MCPG.py:459`
loops `mcpg(filename)` over files). Accelerator-first redesign: stack the per-graph
static data (dense adjacency, degree-ordered sweep tables) along a leading
graph axis and `vmap` the whole MCPG round — MH sampling, degree-ordered
local search, best-of-repeats reduction, REINFORCE update — over it. One
jitted call advances all G instances one sample round, so a 10-instance
distribution benchmark costs the same number of dispatches as a single
instance.

Semantics per graph match `solve_maxcut_mcpg` (`algos/mcpg.py`):
  * MH proposals target the per-graph Bernoulli(probs) product measure with
    the reference's accept budget (num_chains * change_times accepts, round
    cap 5 * change_times — `MCPG.py:88-118`), realised as a fixed-length
    `lax.scan` with budget-masked accepts (same distribution, static shape);
  * local search = `num_ls` degree-ordered sequential sweeps
    (`MCPG.py:120-141`), vmapped over the graph axis;
  * per-chain best-of-repeats + elitist incumbents + worst<-best
    (`MCPG.py:376-394`);
  * REINFORCE on pre-local-search samples with centered energy advantage
    (`MCPG.py:292-302`), Adam(lr), per-epoch policy reset.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from rlsolver_tpu.algos.mcpg import MCPGConfig
from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.ops.reductions import pick_xs_by_vs, update_xs_by_vs
from rlsolver_tpu.ops.sweeps import SweepData, degree_ordered_sweep, mcpg_init_values


class StackedGraphs(NamedTuple):
    """Static per-instance arrays stacked along a leading graph axis."""

    adj: jax.Array  # [G, N, N] bf16 dense adjacency
    total_w: jax.Array  # [G] f32
    sweep: SweepData  # fields [G, ...]; num_nodes is the common N
    num_graphs: int
    num_nodes: int

    @staticmethod
    def build(graphs: Sequence[Graph], dtype=jnp.bfloat16) -> "StackedGraphs":
        n = graphs[0].num_nodes
        if any(g.num_nodes != n for g in graphs):
            raise ValueError("all graphs must share num_nodes")
        datas = [SweepData.build(g) for g in graphs]
        # bucket the neighbor-table width so instance families with nearby
        # max degrees share one compiled program
        max_deg = max(int(d.nbrs.shape[1]) for d in datas)
        max_deg = ((max_deg + 31) // 32) * 32

        def pad_nbrs(d: SweepData):
            pad = max_deg - d.nbrs.shape[1]
            nbrs = jnp.pad(d.nbrs, ((0, 0), (0, pad)), constant_values=n)
            nbr_w = jnp.pad(d.nbr_w, ((0, 0), (0, pad)))
            return nbrs, nbr_w

        nbrs, nbr_w = zip(*(pad_nbrs(d) for d in datas))
        sweep = SweepData(
            order=jnp.stack([d.order for d in datas]),
            nbrs=jnp.stack(nbrs),
            nbr_w=jnp.stack(nbr_w),
            wdeg=jnp.stack([d.wdeg for d in datas]),
            color_masks=jnp.zeros((len(graphs), 1, n), bool),  # unused (sequential)
            num_nodes=n,
        )
        return StackedGraphs(
            adj=jnp.stack([jnp.asarray(g.adjacency_dense(), dtype) for g in graphs]),
            total_w=jnp.asarray([g.total_weight for g in graphs], jnp.float32),
            sweep=sweep,
            num_graphs=len(graphs),
            num_nodes=n,
        )


def cut_values_stacked(xs: jax.Array, sg: StackedGraphs) -> jax.Array:
    """Batched cut via per-graph matmuls. xs bool [G, B, N] -> f32 [G, B]."""
    s = (2 * xs.astype(jnp.int8) - 1).astype(sg.adj.dtype)
    sa = jnp.einsum("gbn,gnm->gbm", s, sg.adj, preferred_element_type=jnp.float32)
    quad = jnp.sum(sa * s.astype(jnp.float32), axis=-1)  # [G, B]
    return (sg.total_w[:, None] - quad / 2.0) / 2.0


def _mh_stacked(
    key: jax.Array,
    probs: jax.Array,  # [G, N]
    bits: jax.Array,  # bool [G, B, N]
    change_times: int,
    round_cap_factor: int = 5,
) -> jax.Array:
    """Budget-masked fixed-length MH scan (metropolis_bitflip_chain parity)."""
    num_graphs, num_chains, num_nodes = bits.shape
    budget = num_chains * change_times

    def body(carry, k):
        bits, cnt = carry
        k_node, k_u = jax.random.split(k)
        nodes = jax.random.randint(k_node, (num_graphs, num_chains), 0, num_nodes)
        p = jnp.take_along_axis(probs, nodes, axis=1)  # [G, B]
        cur = jnp.take_along_axis(bits, nodes[:, :, None], axis=2)[:, :, 0]
        q = jnp.where(cur, p, 1.0 - p)
        accept = jax.random.uniform(k_u, (num_graphs, num_chains)) < (1.0 - q) / q
        accept = jnp.logical_and(accept, (cnt < budget)[:, None])
        new_bit = jnp.where(accept, ~cur, cur)
        bits = jax.vmap(
            jax.vmap(lambda row, i, v: row.at[i].set(v))
        )(bits, nodes, new_bit)
        cnt = cnt + jnp.sum(accept, axis=1, dtype=jnp.int32)
        return (bits, cnt), None

    keys = jax.random.split(key, round_cap_factor * change_times)
    (bits, _), _ = jax.lax.scan(body, (bits, jnp.zeros(num_graphs, jnp.int32)), keys)
    return bits


def solve_maxcut_mcpg_batched(
    graphs: Sequence[Graph],
    cfg: MCPGConfig = MCPGConfig(),
    verbose: bool = False,
) -> Tuple[np.ndarray, np.ndarray, List[dict]]:
    """Solve all `graphs` (same node count) with one vmapped MCPG program.

    Returns (best_x bool [G, N], best_v f32 [G], per-round history).
    """
    sg = StackedGraphs.build(graphs)
    num_graphs, n = sg.num_graphs, sg.num_nodes
    C, R = cfg.total_mcmc_num, cfg.repeat_times
    change_times = cfg.change_times or max(1, n // 10)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(cfg.lr))

    def probs_of(logits):
        return jax.nn.sigmoid(logits) * 0.6 + 0.2  # BernoulliPolicy squash

    sweep_v = jax.vmap(
        degree_ordered_sweep,
        in_axes=(0, 0, SweepData(0, 0, 0, 0, 0, None), None),
    )

    def loss_fn(logits, mh_bits, value):
        probs = probs_of(logits)  # [G, N]
        x = mh_bits.astype(jnp.float32)  # [G, B, N]
        logp = jnp.sum(
            jnp.log(jnp.clip(x * probs[:, None] + (1 - x) * (1 - probs[:, None]), 1e-8)),
            axis=2,
        )
        return jnp.sum(jnp.mean(logp * value, axis=1))

    # the big per-instance arrays ride as jit ARGUMENTS, not closures:
    # closure-captured device arrays lower to IR literals inside the
    # program, and a dense stacked adjacency (ER_3000: 10 x 3000^2 bf16 =
    # 180 MB) would bloat what is handed to the compiler. Same convention
    # as `algos/l2a.py:rollout_step`.
    def _rebuild(adj, total_w, order, nbrs, nbr_w, wdeg):
        sweep = SweepData(
            order=order, nbrs=nbrs, nbr_w=nbr_w, wdeg=wdeg,
            color_masks=jnp.zeros((num_graphs, 1, n), bool), num_nodes=n,
        )
        return StackedGraphs(
            adj=adj, total_w=total_w, sweep=sweep,
            num_graphs=num_graphs, num_nodes=n,
        )

    _sg_args = (sg.adj, sg.total_w, sg.sweep.order, sg.sweep.nbrs,
                sg.sweep.nbr_w, sg.sweep.wdeg)

    def round_step(key, logits, opt_state, best_xs, best_vs, start_bits,
                   adj, total_w, order, nbrs, nbr_w, wdeg):
        sg_ = _rebuild(adj, total_w, order, nbrs, nbr_w, wdeg)
        k_mh, k_ls = jax.random.split(key)
        probs = probs_of(logits)
        mh = _mh_stacked(k_mh, probs, start_bits, change_times)
        xt = jax.vmap(mcpg_init_values)(mh)
        keys_ls = jax.random.split(k_ls, num_graphs)
        xt = sweep_v(keys_ls, xt, sg_.sweep, cfg.num_ls)
        ls_bits = xt[:, :, :n] > 0.5
        cuts = cut_values_stacked(ls_bits, sg_)  # [G, R*C]

        chain_xs, chain_vs = jax.vmap(pick_xs_by_vs, in_axes=(0, 0, None))(
            ls_bits, cuts, R
        )
        best_xs, best_vs = jax.vmap(update_xs_by_vs)(best_xs, best_vs, chain_xs, chain_vs)
        top = jnp.argmax(best_vs, axis=1)
        worst = jnp.argmin(best_vs, axis=1)
        gi = jnp.arange(num_graphs)
        best_xs = best_xs.at[gi, worst].set(best_xs[gi, top])
        best_vs = best_vs.at[gi, worst].set(best_vs[gi, top])
        restart = jnp.tile(chain_xs, (1, R, 1))

        energy = sg_.total_w[:, None] - 2.0 * cuts
        value = energy - jnp.mean(energy, axis=1, keepdims=True)

        def sgd(carry, _):
            logits, opt_state = carry
            grads = jax.grad(loss_fn)(logits, mh, value)
            updates, opt_state = optimizer.update(grads, opt_state, logits)
            return (optax.apply_updates(logits, updates), opt_state), None

        (logits, opt_state), _ = jax.lax.scan(
            sgd, (logits, opt_state), None, length=cfg.sample_epoch_num
        )
        return logits, opt_state, best_xs, best_vs, restart

    round_j = jax.jit(round_step)

    key = jax.random.PRNGKey(cfg.seed)
    key, k_init = jax.random.split(key)
    start_xs = jax.random.bernoulli(k_init, 0.5, (num_graphs, C, n)).at[:, :, 0].set(False)
    # warm start: local-search the initial chains (MCPG.py:342-348 analogue)
    xt0 = jax.vmap(mcpg_init_values)(start_xs)
    key, k_ws = jax.random.split(key)
    warm = jax.jit(
        lambda ks, xt, order, nbrs, nbr_w, wdeg: sweep_v(
            ks, xt,
            SweepData(order=order, nbrs=nbrs, nbr_w=nbr_w, wdeg=wdeg,
                      color_masks=jnp.zeros((num_graphs, 1, n), bool),
                      num_nodes=n),
            cfg.warmup_ls_rounds,
        )
    )
    xt0 = warm(jax.random.split(k_ws, num_graphs), xt0, sg.sweep.order,
               sg.sweep.nbrs, sg.sweep.nbr_w, sg.sweep.wdeg)
    best_xs = xt0[:, :, :n] > 0.5
    best_vs = cut_values_stacked(best_xs, sg)
    start_bits = jnp.tile(best_xs, (1, R, 1))

    history = []
    rounds_per_epoch = max(1, cfg.reset_epoch_num // cfg.sample_epoch_num)
    t0 = time.time()
    for epoch in range(cfg.max_epoch_num):
        logits = jnp.zeros((num_graphs, n), jnp.float32)  # per-epoch reset
        opt_state = optimizer.init(logits)
        for j in range(rounds_per_epoch):
            key, k = jax.random.split(key)
            logits, opt_state, best_xs, best_vs, start_bits = round_j(
                k, logits, opt_state, best_xs, best_vs, start_bits, *_sg_args
            )
        per_graph_best = np.asarray(jnp.max(best_vs, axis=1))
        history.append(
            {"epoch": epoch, "best": per_graph_best, "t": time.time() - t0}
        )
        if verbose:
            print(
                f"epoch {epoch}: mean best {per_graph_best.mean():.1f} "
                f"({time.time() - t0:.1f}s)",
                flush=True,
            )
    top = jnp.argmax(best_vs, axis=1)
    gi = jnp.arange(num_graphs)
    return (
        np.asarray(best_xs[gi, top]),
        np.asarray(best_vs[gi, top]),
        history,
    )
