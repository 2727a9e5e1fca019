"""PPO on the vectorized flip MDP — single-chip and data-parallel.

Reference counterparts:
  * `rlsolver/methods/PPO.py:1-213` — CleanRL-style PPO (GAE, clipped
    surrogate + value clip, entropy bonus, lr annealing, minibatch epochs)
    on the vectorized maxcut flip env, with a 2x128 Tanh MLP actor-critic
    (`PPO.py:54-80`);
  * `rlsolver/methods/S2V_PPO/train_ddp.py:16-258` — the same loop
    data-parallel over GPUs: NCCL process group, per-rank env shards,
    DDP gradient all-reduce, `all_reduce` metric aggregation.

Accelerator-first redesign: the rollout is a `lax.scan` over the horizon (the
reference steps python-side), GAE is a reverse scan, and the whole
iteration (rollout + updates) is ONE jitted function. The distributed
variant runs that function under `shard_map` with envs sharded on the mesh
"env" axis and `psum` on gradients — the SPMD equivalent of DDP
(SURVEY.md section 2.9 P2); no process groups, no pipes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax

from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.envs.flip_mdp import FlipMdpEnv, FlipMdpState


class MLPActorCritic(nn.Module):
    """2x128 Tanh actor-critic over the raw bit vector (`PPO.py:54-80`)."""

    num_nodes: int
    hidden: int = 128

    @nn.compact
    def __call__(self, obs: jax.Array) -> Tuple[jax.Array, jax.Array]:
        def trunk(name):
            def f(x):
                x = nn.tanh(nn.Dense(self.hidden, name=f"{name}0")(x))
                x = nn.tanh(nn.Dense(self.hidden, name=f"{name}1")(x))
                return x

            return f

        logits = nn.Dense(self.num_nodes, name="actor_out")(trunk("actor")(obs))
        value = nn.Dense(1, name="critic_out")(trunk("critic")(obs))[..., 0]
        return logits, value


@dataclasses.dataclass
class PPOConfig:
    num_envs: int = 128
    horizon: int = 64  # steps per rollout (= episode length, `PPO.py:24`)
    num_iterations: int = 100
    num_minibatches: int = 4
    update_epochs: int = 4
    lr: float = 2.5e-4
    anneal_lr: bool = True
    gamma: float = 0.99
    gae_lambda: float = 0.95
    norm_adv: bool = True
    clip_coef: float = 0.2
    clip_vloss: bool = True
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    seed: int = 0
    start_str: Optional[str] = None  # base64 warm-start solution (`PPO.py:19-21`)


class PPOTrainState(NamedTuple):
    params: dict
    opt_state: tuple
    env_state: FlipMdpState
    obs: jax.Array
    key: jax.Array
    iteration: jax.Array  # int32


def gae(rewards, values, dones, last_value, gamma, lam):
    """Generalized advantage estimation, reverse scan over the horizon.

    rewards/values/dones: [T, B]; last_value: [B]. Bootstraps through
    non-terminal tails exactly as `PPO.py`'s backward loop.
    """

    def body(carry, inp):
        adv_next, value_next = carry
        reward, value, done = inp
        nonterminal = 1.0 - done
        delta = reward + gamma * value_next * nonterminal - value
        adv = delta + gamma * lam * nonterminal * adv_next
        return (adv, value), adv

    (_, _), advs = jax.lax.scan(
        body,
        (jnp.zeros_like(last_value), last_value),
        (rewards, values, dones),
        reverse=True,
    )
    return advs


def make_ppo_iteration(
    env: FlipMdpEnv,
    model: nn.Module,
    cfg: PPOConfig,
    axis_name: Optional[str] = None,
):
    """One full PPO iteration (rollout + GAE + minibatch updates) as a pure
    function of PPOTrainState. When `axis_name` is set the function is meant
    to run inside shard_map: gradients and adv statistics are psum-averaged
    over the mesh (DDP semantics)."""
    if cfg.anneal_lr:
        schedule = optax.linear_schedule(
            cfg.lr, 0.0, cfg.num_iterations * cfg.update_epochs * cfg.num_minibatches
        )
    else:
        schedule = cfg.lr
    optimizer = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm), optax.adam(schedule, eps=1e-5)
    )

    def pmean(x):
        return jax.lax.pmean(x, axis_name) if axis_name else x

    def iteration(state: PPOTrainState):
        def rollout_step(carry, k):
            env_state, obs = carry
            logits, value = model.apply(state.params, obs)
            action = jax.random.categorical(k, logits)
            logprob = jax.nn.log_softmax(logits)[
                jnp.arange(action.shape[0]), action
            ]
            env_state, next_obs, reward, done = env.step(env_state, action)
            out = (obs, action, logprob, value, reward, done)
            return (env_state, next_obs), out

        key, k_roll, k_perm = jax.random.split(state.key, 3)
        if axis_name:
            # replicated key carry + per-shard fold-in: shards explore
            # independent trajectories but stay in lockstep
            shard = jax.lax.axis_index(axis_name)
            k_roll = jax.random.fold_in(k_roll, shard)
        (env_state, obs), (obss, actions, logprobs, values, rewards, dones) = (
            jax.lax.scan(
                rollout_step,
                (state.env_state, state.obs),
                jax.random.split(k_roll, cfg.horizon),
            )
        )
        _, last_value = model.apply(state.params, obs)
        advs = gae(rewards, values, dones, last_value, cfg.gamma, cfg.gae_lambda)
        returns = advs + values

        # flatten [T, B] -> [T*B]
        batch = jax.tree.map(
            lambda x: x.reshape((-1,) + x.shape[2:]),
            (obss, actions, logprobs, advs, returns, values),
        )
        batch_size = cfg.horizon * obss.shape[1]
        mb_size = batch_size // cfg.num_minibatches

        def update_minibatch(carry, idx):
            params, opt_state = carry
            obs_b, act_b, logp_b, adv_b, ret_b, val_b = jax.tree.map(
                lambda x: x[idx], batch
            )
            if cfg.norm_adv:
                mean = pmean(adv_b.mean())
                var = pmean(jnp.mean((adv_b - mean) ** 2))
                adv_b = (adv_b - mean) / (jnp.sqrt(var) + 1e-8)

            def loss_fn(p):
                logits, value = model.apply(p, obs_b)
                logp_all = jax.nn.log_softmax(logits)
                logp = logp_all[jnp.arange(act_b.shape[0]), act_b]
                entropy = -jnp.sum(jnp.exp(logp_all) * logp_all, axis=-1).mean()
                ratio = jnp.exp(logp - logp_b)
                pg1 = -adv_b * ratio
                pg2 = -adv_b * jnp.clip(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef)
                pg_loss = jnp.maximum(pg1, pg2).mean()
                if cfg.clip_vloss:
                    v_clip = val_b + jnp.clip(
                        value - val_b, -cfg.clip_coef, cfg.clip_coef
                    )
                    v_loss = 0.5 * jnp.maximum(
                        (value - ret_b) ** 2, (v_clip - ret_b) ** 2
                    ).mean()
                else:
                    v_loss = 0.5 * ((value - ret_b) ** 2).mean()
                return pg_loss - cfg.ent_coef * entropy + cfg.vf_coef * v_loss

            loss, grads = jax.value_and_grad(loss_fn)(params)
            grads = pmean(grads)  # DDP gradient all-reduce equivalent
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        def update_epoch(carry, k):
            perm = jax.random.permutation(k, batch_size)
            idxs = perm[: mb_size * cfg.num_minibatches].reshape(
                cfg.num_minibatches, mb_size
            )
            carry, losses = jax.lax.scan(update_minibatch, carry, idxs)
            return carry, losses.mean()

        (params, opt_state), losses = jax.lax.scan(
            update_epoch,
            (state.params, state.opt_state),
            jax.random.split(k_perm, cfg.update_epochs),
        )

        mean_ep_cut = pmean(env_state.cut.mean())
        best_cut = env_state.cut.max()
        if axis_name:
            best_cut = jax.lax.pmax(best_cut, axis_name)
        metrics = {
            "loss": pmean(losses.mean()),
            "mean_cut": mean_ep_cut,
            "best_cut": best_cut,
            "mean_reward": pmean(rewards.mean()),
        }
        return (
            PPOTrainState(params, opt_state, env_state, obs, key, state.iteration + 1),
            metrics,
        )

    return optimizer, iteration


def init_ppo_state(
    env: FlipMdpEnv, model: nn.Module, optimizer, cfg: PPOConfig, num_envs: int
) -> PPOTrainState:
    key = jax.random.PRNGKey(cfg.seed)
    k_init, k_reset, key = jax.random.split(key, 3)
    start_bits = None
    if cfg.start_str is not None:
        from rlsolver_tpu.core.encode import SolutionCodec

        start_bits = jnp.asarray(
            SolutionCodec(env.num_nodes).str_to_bits(cfg.start_str)
        )
    env_state, obs = env.reset(k_reset, num_envs, start_bits=start_bits)
    params = model.init(k_init, obs)
    return PPOTrainState(
        params, optimizer.init(params), env_state, obs, key, jnp.int32(0)
    )


def train_ppo(
    graph: Graph, cfg: PPOConfig = PPOConfig(), model: Optional[nn.Module] = None
):
    """Single-chip PPO training. Returns (final_state, metrics_history)."""
    env = FlipMdpEnv(graph, horizon=cfg.horizon)
    model = model or MLPActorCritic(graph.num_nodes)
    optimizer, iteration = make_ppo_iteration(env, model, cfg)
    state = init_ppo_state(env, model, optimizer, cfg, cfg.num_envs)
    step = jax.jit(iteration)
    history = []
    for _ in range(cfg.num_iterations):
        state, metrics = step(state)
        history.append({k: float(v) for k, v in metrics.items()})
    return state, history


def train_a2c(
    graph: Graph, cfg: Optional[PPOConfig] = None, model: Optional[nn.Module] = None
):
    """A2C (`ECO_S2V/jumanji/agents/AgentA2C` capability): the PPO loop
    degenerates to advantage actor-critic with one full-batch update per
    rollout and no ratio clipping (single epoch => ratio == 1, so the
    clipped surrogate equals the vanilla policy gradient)."""
    cfg = cfg or PPOConfig()
    cfg = dataclasses.replace(
        cfg, num_minibatches=1, update_epochs=1, clip_coef=10.0, clip_vloss=False
    )
    return train_ppo(graph, cfg, model)


def train_ppo_sharded(
    graph: Graph,
    mesh,
    cfg: PPOConfig = PPOConfig(),
    model: Optional[nn.Module] = None,
    axis_name: str = "env",
):
    """Data-parallel PPO over a device mesh (S2V_PPO DDP equivalent).

    Envs are sharded `num_envs // mesh.size` per device (the reference's
    `local_num_envs = num_parallel_envs // world_size`,
    `train_ddp.py:40-41`); params/optimizer replicated; per-minibatch
    gradients pmean'd. Returns (final_state, metrics_history).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_dev = mesh.devices.size
    assert cfg.num_envs % n_dev == 0, "num_envs must divide over the mesh"
    env = FlipMdpEnv(graph, horizon=cfg.horizon)
    model = model or MLPActorCritic(graph.num_nodes)
    optimizer, iteration = make_ppo_iteration(env, model, cfg, axis_name=axis_name)
    state = init_ppo_state(env, model, optimizer, cfg, cfg.num_envs)

    env_spec = FlipMdpState(P(axis_name), P(axis_name), P())
    state_spec = PPOTrainState(P(), P(), env_spec, P(axis_name), P(), P())
    metric_spec = {
        "loss": P(),
        "mean_cut": P(),
        "best_cut": P(),
        "mean_reward": P(),
    }
    sharded_iter = jax.jit(
        jax.shard_map(
            iteration,
            mesh=mesh,
            in_specs=(state_spec,),
            out_specs=(state_spec, metric_spec),
            check_vma=False,
        )
    )
    rep = NamedSharding(mesh, P())
    shd = NamedSharding(mesh, P(axis_name))
    state = jax.device_put(
        state,
        PPOTrainState(
            jax.tree.map(lambda _: rep, state.params),
            jax.tree.map(lambda _: rep, state.opt_state),
            FlipMdpState(shd, shd, rep),
            shd,
            rep,
            rep,
        ),
    )
    history = []
    for _ in range(cfg.num_iterations):
        state, metrics = sharded_iter(state)
        history.append({k: float(np.asarray(v)) for k, v in metrics.items()})
    return state, history
