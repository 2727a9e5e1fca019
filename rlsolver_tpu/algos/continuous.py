"""Continuous-control agents: DDPG, TD3, SAC (ElegantRL agent-zoo parity).

Reference counterpart: `rlsolver/elegantrl/agents/` — the vendored
ElegantRL runtime ships `AgentDDPG`/`AgentTD3`/`AgentSAC` (~150-260 LoC
each) with soft target updates (`AgentBase.soft_update`
`AgentBase.py:270`), twin critics, delayed policy updates (TD3), and
automatic entropy temperature (SAC). The CO methods themselves only use
DQN/PPO, but the agent zoo is part of the framework surface.

Accelerator-first: one shared off-policy skeleton — pytree replay ring buffer, one
jitted update step per agent; exploration/rollout is the caller's loop
(environments here are pure functions, cf. `rlsolver_tpu.envs`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax


# ----------------------------------------------------------- replay buffer
class Transition(NamedTuple):
    obs: jax.Array
    action: jax.Array
    reward: jax.Array
    next_obs: jax.Array
    done: jax.Array


class Replay(NamedTuple):
    data: Transition
    ptr: jax.Array  # int32
    size: jax.Array  # int32

    @staticmethod
    def create(capacity: int, obs_dim: int, act_dim: int) -> "Replay":
        z = jnp.zeros
        data = Transition(
            z((capacity, obs_dim)),
            z((capacity, act_dim)),
            z((capacity,)),
            z((capacity, obs_dim)),
            z((capacity,)),
        )
        return Replay(data, jnp.int32(0), jnp.int32(0))


def replay_add(buf: Replay, tr: Transition) -> Replay:
    cap = buf.data.reward.shape[0]
    i = buf.ptr
    data = Transition(*(d.at[i].set(x) for d, x in zip(buf.data, tr)))
    return Replay(data, (i + 1) % cap, jnp.minimum(buf.size + 1, cap))


def replay_sample(buf: Replay, key: jax.Array, batch: int) -> Transition:
    idx = jax.random.randint(key, (batch,), 0, jnp.maximum(buf.size, 1))
    return Transition(*(d[idx] for d in buf.data))


# ------------------------------------------------------------------ models
class MLP(nn.Module):
    out_dim: int
    hidden: int = 256
    out_scale: float = 1.0
    tanh_out: bool = False

    @nn.compact
    def __call__(self, *xs):
        x = jnp.concatenate(xs, axis=-1) if len(xs) > 1 else xs[0]
        x = nn.relu(nn.Dense(self.hidden)(x))
        x = nn.relu(nn.Dense(self.hidden)(x))
        x = nn.Dense(self.out_dim)(x)
        return jnp.tanh(x) * self.out_scale if self.tanh_out else x


def soft_update(target, online, tau: float):
    """Polyak averaging (`AgentBase.soft_update`)."""
    return jax.tree.map(lambda t, o: t * (1.0 - tau) + o * tau, target, online)


@dataclasses.dataclass
class OffPolicyConfig:
    obs_dim: int = 4
    act_dim: int = 2
    max_action: float = 1.0
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    batch: int = 128
    capacity: int = 100_000
    # TD3
    policy_delay: int = 2
    target_noise: float = 0.2
    noise_clip: float = 0.5
    # SAC
    init_alpha: float = 0.1
    seed: int = 0


class OffPolicyState(NamedTuple):
    actor: dict
    actor_target: dict
    critic: dict
    critic_target: dict
    actor_opt: tuple
    critic_opt: tuple
    log_alpha: jax.Array
    alpha_opt: tuple
    step: jax.Array


class _TwinCritic(nn.Module):
    hidden: int = 256

    @nn.compact
    def __call__(self, obs, act):
        q1 = MLP(1, self.hidden, name="q1")(obs, act)[..., 0]
        q2 = MLP(1, self.hidden, name="q2")(obs, act)[..., 0]
        return q1, q2


class _GaussianActor(nn.Module):
    act_dim: int
    max_action: float
    hidden: int = 256

    @nn.compact
    def __call__(self, obs):
        x = nn.relu(nn.Dense(self.hidden)(obs))
        x = nn.relu(nn.Dense(self.hidden)(x))
        mu = nn.Dense(self.act_dim, name="mu")(x)
        log_std = jnp.clip(nn.Dense(self.act_dim, name="log_std")(x), -10.0, 2.0)
        return mu, log_std

    def sample(self, params, obs, key):
        mu, log_std = self.apply(params, obs)
        std = jnp.exp(log_std)
        eps = jax.random.normal(key, mu.shape)
        pre = mu + std * eps
        act = jnp.tanh(pre) * self.max_action
        # tanh-squashed log prob
        logp = (
            -0.5 * (eps**2 + 2.0 * log_std + np.log(2.0 * np.pi)).sum(-1)
            - jnp.log(1.0 - jnp.tanh(pre) ** 2 + 1e-6).sum(-1)
        )
        return act, logp


class OffPolicyAgent:
    """Shared DDPG / TD3 / SAC implementation, selected by `algo`."""

    def __init__(self, algo: str, cfg: OffPolicyConfig = OffPolicyConfig()):
        assert algo in ("ddpg", "td3", "sac")
        self.algo = algo
        self.cfg = cfg
        if algo == "sac":
            self.actor = _GaussianActor(cfg.act_dim, cfg.max_action)
        else:
            self.actor = MLP(cfg.act_dim, out_scale=cfg.max_action, tanh_out=True)
        self.critic = _TwinCritic()
        self.actor_optim = optax.adam(cfg.lr)
        self.critic_optim = optax.adam(cfg.lr)
        self.alpha_optim = optax.adam(cfg.lr)
        self.target_entropy = -float(cfg.act_dim)

    def init(self) -> OffPolicyState:
        cfg = self.cfg
        key = jax.random.PRNGKey(cfg.seed)
        obs = jnp.zeros((1, cfg.obs_dim))
        act = jnp.zeros((1, cfg.act_dim))
        a = self.actor.init(key, obs)
        c = self.critic.init(key, obs, act)
        log_alpha = jnp.asarray(np.log(cfg.init_alpha), jnp.float32)
        return OffPolicyState(
            a, a, c, c,
            self.actor_optim.init(a), self.critic_optim.init(c),
            log_alpha, self.alpha_optim.init(log_alpha), jnp.int32(0),
        )

    def act(self, state: OffPolicyState, obs, key=None, explore_std: float = 0.1):
        if self.algo == "sac":
            key = key if key is not None else jax.random.PRNGKey(0)
            a, _ = self.actor.sample(state.actor, obs, key)
            return a
        a = self.actor.apply(state.actor, obs)
        if key is not None and explore_std > 0:
            a = a + jax.random.normal(key, a.shape) * explore_std * self.cfg.max_action
            a = jnp.clip(a, -self.cfg.max_action, self.cfg.max_action)
        return a

    def make_update(self):
        cfg = self.cfg

        def critic_targets(state, batch: Transition, key):
            if self.algo == "sac":
                next_a, next_logp = self.actor.sample(
                    state.actor, batch.next_obs, key
                )
                tq1, tq2 = self.critic.apply(
                    state.critic_target, batch.next_obs, next_a
                )
                alpha = jnp.exp(state.log_alpha)
                tq = jnp.minimum(tq1, tq2) - alpha * next_logp
            else:
                next_a = self.actor.apply(state.actor_target, batch.next_obs)
                if self.algo == "td3":
                    noise = jnp.clip(
                        jax.random.normal(key, next_a.shape) * cfg.target_noise,
                        -cfg.noise_clip,
                        cfg.noise_clip,
                    )
                    next_a = jnp.clip(
                        next_a + noise, -cfg.max_action, cfg.max_action
                    )
                tq1, tq2 = self.critic.apply(
                    state.critic_target, batch.next_obs, next_a
                )
                tq = jnp.minimum(tq1, tq2) if self.algo == "td3" else tq1
            return batch.reward + cfg.gamma * (1.0 - batch.done) * tq

        @jax.jit
        def update(state: OffPolicyState, batch: Transition, key):
            k_t, k_a = jax.random.split(key)
            y = jax.lax.stop_gradient(critic_targets(state, batch, k_t))

            def critic_loss(cp):
                q1, q2 = self.critic.apply(cp, batch.obs, batch.action)
                return ((q1 - y) ** 2).mean() + ((q2 - y) ** 2).mean()

            closs, cgrad = jax.value_and_grad(critic_loss)(state.critic)
            cupd, critic_opt = self.critic_optim.update(cgrad, state.critic_opt)
            critic = optax.apply_updates(state.critic, cupd)
            state = state._replace(critic=critic, critic_opt=critic_opt)

            def actor_loss(ap):
                if self.algo == "sac":
                    a, logp = self.actor.sample(ap, batch.obs, k_a)
                    q1, q2 = self.critic.apply(state.critic, batch.obs, a)
                    alpha = jax.lax.stop_gradient(jnp.exp(state.log_alpha))
                    return (alpha * logp - jnp.minimum(q1, q2)).mean(), logp
                a = self.actor.apply(ap, batch.obs)
                q1, _ = self.critic.apply(state.critic, batch.obs, a)
                return -q1.mean(), jnp.zeros(batch.reward.shape[0])

            do_actor = (self.algo != "td3") | (state.step % cfg.policy_delay == 0)
            (aloss, logp), agrad = jax.value_and_grad(actor_loss, has_aux=True)(
                state.actor
            )
            agrad = jax.tree.map(
                lambda g: jnp.where(do_actor, g, jnp.zeros_like(g)), agrad
            )
            aupd, actor_opt = self.actor_optim.update(agrad, state.actor_opt)
            actor = optax.apply_updates(state.actor, aupd)

            log_alpha, alpha_opt = state.log_alpha, state.alpha_opt
            if self.algo == "sac":
                def alpha_loss(la):
                    return -(la * jax.lax.stop_gradient(logp + self.target_entropy)).mean()

                lgrad = jax.grad(alpha_loss)(log_alpha)
                lupd, alpha_opt = self.alpha_optim.update(lgrad, alpha_opt)
                log_alpha = optax.apply_updates(log_alpha, lupd)

            return state._replace(
                actor=actor,
                actor_opt=actor_opt,
                actor_target=soft_update(state.actor_target, actor, cfg.tau),
                critic_target=soft_update(state.critic_target, state.critic, cfg.tau),
                log_alpha=log_alpha,
                alpha_opt=alpha_opt,
                step=state.step + 1,
            ), {"critic_loss": closs, "actor_loss": aloss}

        return update


# ------------------------------------------------------------- EmbedDQN
class QEmbedTwin(nn.Module):
    """ElegantRL's embedded-action Q network (`QEmbedBase`/`QEmbedTwin`,
    reference `elegantrl/agents/AgentEmbedDQN.py:106-186`): Q(s, a) scored
    from the state concatenated with a learned embedding of the *discrete*
    action (embedding_dim = max(8, sqrt(action_dim))), with `num_ensembles`
    twin heads trained against a shared label."""

    action_dim: int
    hidden: int = 128
    num_ensembles: int = 2

    @nn.compact
    def __call__(self, obs: jax.Array, action_int: jax.Array) -> jax.Array:
        emb_dim = max(8, int(self.action_dim**0.5))
        emb = nn.Embed(
            self.action_dim,
            emb_dim,
            embedding_init=nn.initializers.orthogonal(0.5),
        )(action_int)
        x = jnp.concatenate([obs, emb], axis=-1)
        x = nn.relu(nn.Dense(self.hidden)(x))
        x = nn.relu(nn.Dense(self.hidden)(x))
        return nn.Dense(self.num_ensembles)(x)  # [..., num_ensembles]


@dataclasses.dataclass
class EmbedDQNConfig:
    obs_dim: int = 4
    action_dim: int = 4
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 1e-3
    batch: int = 128
    capacity: int = 20_000
    explore_rate: float = 0.25  # reference AgentEmbedDQN.explore_rate
    seed: int = 0


class EmbedDQNState(NamedTuple):
    params: dict
    target: dict
    opt_state: tuple
    step: jax.Array


class EmbedDQNAgent:
    """`AgentEmbedDQN` equivalent (reference
    `elegantrl/agents/AgentEmbedDQN.py:14-71`): epsilon-greedy exploration
    over all-action Q scores, TD target = r + gamma * undone *
    max_a mean-ensemble Q_target(s', a), MSE on the taken action's ensemble
    against the repeated label, Polyak target updates."""

    def __init__(self, cfg: EmbedDQNConfig = EmbedDQNConfig()):
        self.cfg = cfg
        self.net = QEmbedTwin(cfg.action_dim)
        self.optim = optax.adam(cfg.lr)

    def init(self) -> EmbedDQNState:
        key = jax.random.PRNGKey(self.cfg.seed)
        obs = jnp.zeros((1, self.cfg.obs_dim))
        act = jnp.zeros((1,), jnp.int32)
        p = self.net.init(key, obs, act)
        return EmbedDQNState(p, p, self.optim.init(p), jnp.int32(0))

    def q_all(self, params, obs: jax.Array) -> jax.Array:
        """Mean-ensemble Q for every action: [B, action_dim]."""
        a = self.cfg.action_dim
        acts = jnp.arange(a, dtype=jnp.int32)
        obs_t = jnp.broadcast_to(obs[:, None, :], (obs.shape[0], a, obs.shape[1]))
        acts_t = jnp.broadcast_to(acts[None, :], (obs.shape[0], a))
        return self.net.apply(params, obs_t, acts_t).mean(axis=-1)

    def act(self, state: EmbedDQNState, obs: jax.Array, key: jax.Array,
            explore: bool = True) -> jax.Array:
        """Epsilon-greedy action ints [B] (`QEmbedBase.get_action`)."""
        greedy = jnp.argmax(self.q_all(state.params, obs), axis=1)
        if not explore:
            return greedy
        k1, k2 = jax.random.split(key)
        rand = jax.random.randint(k1, greedy.shape, 0, self.cfg.action_dim)
        pick = jax.random.uniform(k2, ()) < self.cfg.explore_rate
        return jnp.where(pick, rand, greedy)

    def make_update(self):
        cfg = self.cfg

        @jax.jit
        def update(state: EmbedDQNState, batch: Transition):
            action_int = batch.action.astype(jnp.int32)[:, 0]
            next_q = self.q_all(state.target, batch.next_obs).max(axis=1)
            y = batch.reward + cfg.gamma * (1.0 - batch.done) * next_q
            y = jax.lax.stop_gradient(y)

            def loss(p):
                q = self.net.apply(p, batch.obs, action_int)  # [B, E]
                return ((q - y[:, None]) ** 2).mean()

            l, grads = jax.value_and_grad(loss)(state.params)
            upd, opt_state = self.optim.update(grads, state.opt_state)
            params = optax.apply_updates(state.params, upd)
            target = soft_update(state.target, params, cfg.tau)
            return EmbedDQNState(params, target, opt_state, state.step + 1), l

        return update
