"""dREINFORCE / L2A: the reference's flagship Pattern-II method.

Capability-parity rebuild of `rlsolver/methods/L2A/demo_instance.py:25-278`
(instance-wise) and `demo_distribution.py` (distribution-wise):

  stage 1: pretrain a graph-embedding transformer by adjacency
           reconstruction (`graph_embedding_pretrain.py:105-191`) and freeze
           its per-node `seq_graph` features;
  stage 2: PPO-style improvement loop — per rollout step the policy maps the
           incumbent solutions to per-node flip probabilities, the
           `top_k` most uncertain bits are resampled into `num_repeats`
           candidates (`sub_set_sampling`), each candidate is refined by the
           parallel local search, the best-of-repeats elitist-updates the
           incumbents, and (reward = incumbent improvement, logprob, state)
           go to a replay buffer; updates use GAE(lambda=0.98, gamma=1) with
           clipped-surrogate PPO + entropy bonus + SmoothL1 critic
           (`demo_instance.py:131-252`).

Rollout step and PPO update are two jitted programs; the PPO
minibatch loop is a `lax.scan`; the evaluator is the only host round-trip.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.core.result import write_graph_result
from rlsolver_tpu.envs.maxcut import MaxcutEnv
from rlsolver_tpu.eval.evaluator import Evaluator
from rlsolver_tpu.models.transformer import (
    GraphEncoder,
    PolicyTrsWithValue,
    solution_to_prob_channels,
)
from rlsolver_tpu.ops.counter_rng import seed_from_key
from rlsolver_tpu.ops.pallas.mcpg_sweep import WeightedSweepTables, mcpg_sweep_fused
from rlsolver_tpu.ops.pallas.mh_sampler import require_gpu
from rlsolver_tpu.ops.reductions import pick_xs_by_vs, update_xs_by_vs
from rlsolver_tpu.ops.sampling import sub_set_sampling


@dataclasses.dataclass
class L2AConfig:
    num_sims: int = 256
    num_repeats: int = 8
    top_k: int = 16  # uncertain bits resampled per step
    num_searchers: int = 2  # local-search rounds per candidate batch
    seq_len: int = 16  # rollout length per iteration
    num_iters: int = 8
    embed_dim: int = 64
    num_heads: int = 4
    pretrain_steps: int = 200
    pretrain_lr: float = 1e-3
    lr: float = 1e-4
    gae_lambda: float = 0.98
    ratio_clip: float = 0.25
    lambda_entropy: float = 0.02
    update_times: int = 16  # PPO minibatches per iteration
    prob_noise: float = 0.02  # exploration noise on policy probs
    ls_iters: int = 4
    ls_num_spin: int = 8
    seed: int = 0
    # fused_ls: replace the noisy-top-k local search in the rollout step with
    # `fused_sweeps` degree-ordered packed sweeps (ops/pallas/mcpg_sweep.py)
    # over all candidates — the MCPG-class search budget that makes the
    # flagship competitive at Gset scale (GPU only; integer weights).
    fused_ls: bool = False
    fused_sweeps: int = 8


# ---------------------------------------------------------------- pretraining
def pretrain_graph_encoder(
    graph: Graph, cfg: L2AConfig, key: jax.Array
) -> Tuple[GraphEncoder, dict, jax.Array]:
    """Adjacency-reconstruction pretraining on noisy copies of the instance
    adjacency (instance-wise; the distribution-wise variant feeds random
    graphs). Returns (module, params, frozen seq_graph [N, D])."""
    n = graph.num_nodes
    enc = GraphEncoder(num_nodes=n, embed_dim=cfg.embed_dim, num_heads=cfg.num_heads)
    adj = jnp.asarray(graph.adjacency_dense(), jnp.float32)
    key, k_init = jax.random.split(key)
    params = enc.init(k_init, adj[None])
    opt = optax.adam(cfg.pretrain_lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, key, adj):
        # adj is a jit ARGUMENT (a closure constant would lower the [N, N]
        # matrix into the IR as a literal — 400 MB at G70 scale)
        k_drop, k_flip = jax.random.split(key)
        # corrupt: drop 10% of edges at random, reconstruct the original
        keep = jax.random.bernoulli(k_drop, 0.9, adj.shape)
        noisy = adj * keep * keep.T

        def loss_fn(p):
            recon, _ = enc.apply(p, noisy[None])
            return optax.sigmoid_binary_cross_entropy(recon[0], (adj > 0).astype(jnp.float32)).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    for i in range(cfg.pretrain_steps):
        key, k = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, k, adj)
    seq_graph = enc.embed(params, adj[None])[0]  # [N, D]
    return enc, params, jax.lax.stop_gradient(seq_graph)


# -------------------------------------------------------------------- trainer
class RolloutBatch(NamedTuple):
    states: jax.Array  # bool [T+1, B, N]
    rewards: jax.Array  # f32 [T, B]
    logprobs: jax.Array  # f32 [T, B]


def _build_l2a_steps(
    env: MaxcutEnv, net, seq_graph, cfg: L2AConfig, optimizer, axis_name=None
):
    """Shared jittable pieces of the dREINFORCE loop: one policy-guided
    improvement step and the PPO+GAE update. Used by both the classic host
    loop (`solve_maxcut_l2a`) and the unified-runtime path
    (`solve_maxcut_l2a_runner`).

    `axis_name`: when set, the functions are meant to run inside a
    `shard_map` with the sim axis sharded on that mesh axis — minibatch
    gradients are `pmean`'d across shards before the optimizer update
    (data-parallel dREINFORCE, the S2V_PPO DDP pattern,
    ref `train_ddp.py:16-258`); advantage normalization stays per-shard."""

    def rollout_step(key, params, best_xs, best_vs, adj=None, tables=None):
        """One policy-guided improvement step; returns transition pieces.

        `adj` (the env's dense adjacency) is threaded as a jit ARGUMENT:
        closed-over device arrays lower to dense IR literals, and the
        [N, N] adjacency at G70 scale (200 MB) would bloat the program
        that is handed to the compiler. The remaining CutGraph
        leaves are per-edge arrays (small) and stay closure constants.
        `tables` (packed sweep masks, same IR-bloat argument) powers the
        fused-sweep search when cfg.fused_ls is set."""
        env_ = env
        if adj is not None and env.cg.adj is not None:
            import copy as _copy

            env_ = _copy.copy(env)
            env_.cg = env.cg._replace(adj=adj)
        k_noise, k_sample, k_ls, k_pos, k_draw = jax.random.split(key, 5)
        logits, _ = net.apply(params, solution_to_prob_channels(best_xs), seq_graph)
        probs = jax.nn.softmax(logits, axis=-1)[..., 0]
        probs = jnp.clip(
            probs + jax.random.normal(k_noise, probs.shape) * cfg.prob_noise, 0.0, 1.0
        )
        full_xs = sub_set_sampling(k_sample, probs, best_xs, cfg.num_repeats, cfg.top_k)
        if cfg.num_repeats > 1:
            # epsilon-exploration group (same rationale as
            # l2a_distribution._guided_round): the last repeat group
            # perturbs k RANDOM positions at p=0.5 so a confident-but-wrong
            # policy cannot stall the search on its own top-k-uncertain set
            s, n_bits = best_xs.shape
            k_e = min(cfg.top_k, n_bits)
            rand_ids = jax.random.randint(k_pos, (s, k_e), 0, n_bits)
            rows_e = jnp.arange(s)[:, None]
            explore = best_xs.at[rows_e, rand_ids].set(
                jax.random.bernoulli(k_draw, 0.5, (s, k_e))
            )
            full_xs = jax.lax.dynamic_update_slice_in_dim(
                full_xs, explore, (cfg.num_repeats - 1) * s, axis=0
            )
        if cfg.fused_ls and tables is not None:
            # MCPG-class search budget: `fused_sweeps` noisy degree-ordered
            # packed sweeps over all candidates (ops/pallas/mcpg_sweep.py)
            full_xs = mcpg_sweep_fused(
                seed_from_key(k_ls), full_xs, tables, num_sweeps=cfg.fused_sweeps
            )
            full_vs = env_.obj(full_xs)
        else:
            full_vs = env_.obj(full_xs)
            for i in range(cfg.num_searchers):
                k_ls, k = jax.random.split(k_ls)
                full_xs, full_vs = env_.local_search(
                    k, full_xs, full_vs, num_iters=cfg.ls_iters, num_spin=cfg.ls_num_spin
                )
        good_xs, good_vs = pick_xs_by_vs(full_xs, full_vs, cfg.num_repeats)
        new_xs, new_vs = update_xs_by_vs(best_xs, best_vs, good_xs, good_vs)
        reward = new_vs - best_vs
        logprob = jnp.sum(
            jnp.log(jnp.clip(jnp.where(new_xs, probs, 1 - probs), 0.005, 0.995)), axis=1
        )
        return new_xs, new_vs, reward, logprob

    def ppo_update(key, params, opt_state, batch: RolloutBatch):
        states, rewards, logprobs = batch
        seq_len, num_sims = rewards.shape  # num_sims is per-shard under shard_map

        # values for GAE (no grad)
        def value_of(xs):
            _, v = net.apply(params, solution_to_prob_channels(xs), seq_graph)
            return v

        values = jax.vmap(value_of)(states[:-1])  # [T, B]
        # GAE with gamma=1 (reference get_advantages, transformer.py:290-302)
        def gae_body(carry, inp):
            next_value, adv = carry
            r, v = inp
            delta = r + next_value - v
            adv = delta + cfg.gae_lambda * adv
            return (v, adv), adv

        (_, _), advantages = jax.lax.scan(
            gae_body,
            (jnp.zeros_like(rewards[0]), jnp.zeros_like(rewards[0])),
            (rewards, values),
            reverse=True,
        )
        reward_sums = advantages + values
        advantages = (advantages - advantages.mean()) / (advantages.std() + 1e-5)

        def minibatch(carry, k):
            params, opt_state = carry
            ids = jax.random.randint(k, (num_sims,), 0, seq_len * num_sims)
            t_ids = ids % seq_len
            b_ids = ids // seq_len
            curr_xs = states[t_ids, b_ids]
            next_xs = states[t_ids + 1, b_ids]
            old_logprob = logprobs[t_ids, b_ids]
            advantage = advantages[t_ids, b_ids]
            reward_sum = reward_sums[t_ids, b_ids]

            def loss_fn(p):
                logits, value = net.apply(
                    p, solution_to_prob_channels(curr_xs), seq_graph
                )
                logp2 = jax.nn.log_softmax(logits, axis=-1)  # [b, N, 2]
                new_logprob = jnp.sum(
                    jnp.where(next_xs, logp2[..., 0], logp2[..., 1]), axis=-1
                )
                p2 = jax.nn.softmax(logits, axis=-1)
                entropy = jnp.mean(
                    jnp.sum(p2 * jnp.log2(jnp.clip(p2, 1e-9, 1.0)), axis=-1), axis=-1
                )
                obj_critic = optax.huber_loss(value, reward_sum).mean()
                ratio = jnp.exp(jnp.clip(new_logprob - old_logprob, -12.0, 12.0))
                surr1 = advantage * ratio
                surr2 = advantage * jnp.clip(
                    ratio, 1 - cfg.ratio_clip, 1 + cfg.ratio_clip
                )
                obj_surrogate = jnp.minimum(surr1, surr2).mean()
                obj_policy = obj_surrogate + entropy.mean() * cfg.lambda_entropy
                # maximize surrogate => minimize critic - policy
                return obj_critic - obj_policy

            loss, grads = jax.value_and_grad(loss_fn)(params)
            if axis_name is not None:
                grads = jax.lax.pmean(grads, axis_name)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            minibatch, (params, opt_state), jax.random.split(key, cfg.update_times)
        )
        return params, opt_state, losses

    return rollout_step, ppo_update


def _l2a_setup(graph: Graph, cfg: L2AConfig):
    """Common setup: env, encoder pretrain, policy net, optimizer."""
    env = MaxcutEnv(graph)
    env._sweep_tables = None
    if cfg.fused_ls:
        require_gpu(False, "L2A fused_ls")
        env._sweep_tables = WeightedSweepTables.build(graph)
    n = graph.num_nodes
    key = jax.random.PRNGKey(cfg.seed)
    key, k_pre = jax.random.split(key)
    _, _, seq_graph = pretrain_graph_encoder(graph, cfg, k_pre)
    net = PolicyTrsWithValue(embed_dim=cfg.embed_dim, num_heads=cfg.num_heads)
    key, k_init = jax.random.split(key)
    params = net.init(
        k_init, solution_to_prob_channels(jnp.zeros((cfg.num_sims, n), bool)), seq_graph
    )
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(cfg.lr))
    opt_state = optimizer.init(params)
    return env, n, key, seq_graph, net, params, optimizer, opt_state


def solve_maxcut_l2a(
    graph: Graph,
    cfg: L2AConfig = L2AConfig(),
    instance_file: Optional[str] = None,
    save_dir: Optional[str] = None,
    verbose: bool = False,
    time_budget: Optional[float] = None,
):
    """Instance-wise dREINFORCE. Returns (best_x, best_v, evaluator).
    `time_budget` (seconds) stops the iteration loop early (fixed-time
    benchmark protocol, reference `README.md:335`)."""
    env, n, key, seq_graph, net, params, optimizer, opt_state = _l2a_setup(graph, cfg)
    rollout_step, ppo_update = _build_l2a_steps(env, net, seq_graph, cfg, optimizer)
    rollout_jit = jax.jit(rollout_step)
    ppo_jit = jax.jit(ppo_update)

    key, k_xs = jax.random.split(key)
    best_xs = env.random_xs(k_xs, cfg.num_sims)
    best_vs = env.obj(best_xs)
    evaluator = Evaluator(save_dir, n, np.asarray(best_xs[0]), float(best_vs[0]), True)
    start = time.time()

    tables = env._sweep_tables
    for iter_i in range(cfg.num_iters):
        states = [best_xs]
        rewards, logprobs = [], []
        for t in range(cfg.seq_len):
            key, k = jax.random.split(key)
            best_xs, best_vs, reward, logprob = rollout_jit(
                k, params, best_xs, best_vs, env.cg.adj, tables
            )
            states.append(best_xs)
            rewards.append(reward)
            logprobs.append(logprob)
        batch = RolloutBatch(
            states=jnp.stack(states), rewards=jnp.stack(rewards), logprobs=jnp.stack(logprobs)
        )
        key, k = jax.random.split(key)
        params, opt_state, losses = ppo_jit(k, params, opt_state, batch)
        evaluator.record(iter_i + 1, np.asarray(best_vs), np.asarray(best_xs))
        if verbose:
            print(evaluator.log_line(iter_i + 1, f"ppo_loss {float(losses.mean()):.4f}"))
        if time_budget is not None and time.time() - start > time_budget:
            break

    evaluator.save()
    if instance_file is not None:
        write_graph_result(
            evaluator.best_v,
            time.time() - start,
            n,
            "dreinforce_l2a",
            evaluator.best_x.astype(int),
            instance_file,
        )
    return evaluator.best_x, evaluator.best_v, evaluator


class L2ALoopState(NamedTuple):
    """Full resumable state for the TrainLoop-driven dREINFORCE run."""

    params: dict
    opt_state: optax.OptState
    key: jax.Array
    best_xs: jax.Array
    best_vs: jax.Array


def solve_maxcut_l2a_runner(
    graph: Graph,
    cfg: L2AConfig = L2AConfig(),
    run_dir: str = "runs/l2a",
    checkpoint_every: int = 0,
    resume: bool = False,
    log_every: int = 1,
):
    """Instance-wise dREINFORCE through the unified runtime
    (`train/runner.py:TrainLoop`): one step = the full seq_len rollout (as a
    `lax.scan`) + the PPO update, so checkpoint/resume, metrics.jsonl, and
    the stop sentinel cover the whole training state (params, opt state,
    PRNG key, incumbent archive). Returns (best_x, best_v, final_state)."""
    from rlsolver_tpu.train.runner import LoopConfig, TrainLoop

    env, n, key, seq_graph, net, params, optimizer, opt_state = _l2a_setup(graph, cfg)
    rollout_step, ppo_update = _build_l2a_steps(env, net, seq_graph, cfg, optimizer)

    def step_fn(state: L2ALoopState):
        key, k_roll, k_ppo = jax.random.split(state.key, 3)

        def roll(carry, k):
            xs, vs = carry
            # adj and sweep tables ride as jit arguments (not closure
            # constants) so the runner's program stays small at G70 scale,
            # matching solve_maxcut_l2a's rollout call.
            tables = env._sweep_tables
            new_xs, new_vs, reward, logprob = rollout_step(
                k, state.params, xs, vs, env.cg.adj, tables
            )
            return (new_xs, new_vs), (new_xs, reward, logprob)

        (best_xs, best_vs), (step_states, rewards, logprobs) = jax.lax.scan(
            roll, (state.best_xs, state.best_vs),
            jax.random.split(k_roll, cfg.seq_len),
        )
        states = jnp.concatenate([state.best_xs[None], step_states], axis=0)
        batch = RolloutBatch(states=states, rewards=rewards, logprobs=logprobs)
        params, opt_state, losses = ppo_update(
            k_ppo, state.params, state.opt_state, batch
        )
        metrics = {
            "best_cut": jnp.max(best_vs),
            "mean_cut": jnp.mean(best_vs),
            "ppo_loss": jnp.mean(losses),
        }
        return L2ALoopState(params, opt_state, key, best_xs, best_vs), metrics

    key, k_xs = jax.random.split(key)
    best_xs = env.random_xs(k_xs, cfg.num_sims)
    state = L2ALoopState(
        params=params,
        opt_state=opt_state,
        key=key,
        best_xs=best_xs,
        best_vs=env.obj(best_xs),
    )
    loop = TrainLoop(
        LoopConfig(
            run_dir=run_dir,
            total_steps=cfg.num_iters,
            log_every=log_every,
            checkpoint_every=checkpoint_every,
            resume=resume,
            samples_per_step=cfg.seq_len * cfg.num_sims * cfg.num_repeats,
        ),
        step_fn,
    )
    state = loop.run(state)
    top = int(jnp.argmax(state.best_vs))
    return np.asarray(state.best_xs[top]), float(state.best_vs[top]), state
