"""Multi-agent RL: VDN, QMIX, MAPPO, MADDPG (ElegantRL zoo parity).

Reference counterpart: `rlsolver/elegantrl/agents/` — the vendored
multi-agent family: `AgentVDN` (157 LoC, joint Q = sum of per-agent Qs),
`AgentQMix` (227, monotonic mixing network with abs-weight hypernetworks),
`AgentMAPPO` (404, centralized value + per-agent actors), `AgentMADDPG`
(206, centralized critics over joint obs/actions with per-agent
deterministic actors).

Accelerator-first: agents are a leading array axis (vmapped heads over shared
module definitions), the whole update is one jitted step, and replay
reuses the pytree buffers from `rlsolver_tpu.algos.continuous` /
`rlsolver_tpu.train.replay`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax

from rlsolver_tpu.algos.continuous import MLP, soft_update


# ------------------------------------------------------------- value mixing
class AgentQNet(nn.Module):
    """Per-agent Q network over the agent's local observation."""

    num_actions: int
    hidden: int = 64

    @nn.compact
    def __call__(self, obs):  # [.., n_agents, obs_dim]
        x = nn.relu(nn.Dense(self.hidden)(obs))
        x = nn.relu(nn.Dense(self.hidden)(x))
        return nn.Dense(self.num_actions)(x)  # [.., n_agents, A]


class QMixer(nn.Module):
    """Monotonic mixer: weights from |hypernet(state)| (QMIX)."""

    n_agents: int
    embed: int = 32

    @nn.compact
    def __call__(self, agent_qs, state):
        """agent_qs [B, n]; state [B, S] -> joint Q [B].

        Hypernet layers use small init: with default init and an
        unnormalized state, |w1| ~ O(state scale) and the mixed Q starts in
        the hundreds, which the bootstrapped target then amplifies."""
        small = nn.initializers.normal(0.05)
        w1 = jnp.abs(nn.Dense(self.n_agents * self.embed, name="hw1", kernel_init=small)(state))
        b1 = nn.Dense(self.embed, name="hb1", kernel_init=small)(state)
        w1 = w1.reshape(-1, self.n_agents, self.embed)
        h = nn.elu(jnp.einsum("bn,bne->be", agent_qs, w1) + b1)
        w2 = jnp.abs(nn.Dense(self.embed, name="hw2", kernel_init=small)(state))
        b2 = nn.Dense(1, name="hb2", kernel_init=small)(
            nn.relu(nn.Dense(self.embed, name="hb2h", kernel_init=small)(state))
        )
        return jnp.einsum("be,be->b", h, w2) + b2[..., 0]


@dataclasses.dataclass
class MixConfig:
    n_agents: int = 3
    obs_dim: int = 4
    state_dim: int = 12
    num_actions: int = 5
    gamma: float = 0.95
    lr: float = 5e-4
    tau: float = 0.01
    seed: int = 0


class MixState(NamedTuple):
    params: dict
    target: dict
    opt_state: tuple


class ValueMixAgent:
    """VDN (`mixer="sum"`) and QMIX (`mixer="qmix"`) share everything but
    the mixing function."""

    def __init__(self, mixer: str, cfg: MixConfig = MixConfig()):
        assert mixer in ("sum", "qmix")
        self.mixer = mixer
        self.cfg = cfg
        self.qnet = AgentQNet(cfg.num_actions)
        self.mix_net = QMixer(cfg.n_agents) if mixer == "qmix" else None
        # clip hard: the abs-weight hypernetwork can enter a positive
        # feedback loop with the soft-updated target otherwise
        self.opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(cfg.lr))

    def init(self) -> MixState:
        cfg = self.cfg
        key = jax.random.PRNGKey(cfg.seed)
        obs = jnp.zeros((1, cfg.n_agents, cfg.obs_dim))
        params = {"q": self.qnet.init(key, obs)}
        if self.mix_net is not None:
            params["mix"] = self.mix_net.init(
                key, jnp.zeros((1, cfg.n_agents)), jnp.zeros((1, cfg.state_dim))
            )
        return MixState(params, params, self.opt.init(params))

    def q_values(self, params, obs):
        return self.qnet.apply(params["q"], obs)  # [B, n, A]

    def act(self, state: MixState, obs, key, epsilon: float = 0.05):
        q = self.q_values(state.params, obs)
        greedy = jnp.argmax(q, axis=-1)
        rand = jax.random.randint(key, greedy.shape, 0, self.cfg.num_actions)
        explore = jax.random.bernoulli(key, epsilon, greedy.shape)
        return jnp.where(explore, rand, greedy)

    def _joint(self, params, obs, actions, state_global):
        q = self.q_values(params, obs)
        chosen = jnp.take_along_axis(q, actions[..., None], axis=-1)[..., 0]  # [B, n]
        if self.mixer == "sum":
            return chosen.sum(axis=-1)
        return self.mix_net.apply(params["mix"], chosen, state_global)

    def make_update(self):
        cfg = self.cfg

        @jax.jit
        def update(st: MixState, obs, actions, reward, next_obs, done, state_g, next_state_g):
            # double-DQN style target: argmax online, evaluate target
            q_next_online = self.q_values(st.params, next_obs)
            a_star = jnp.argmax(q_next_online, axis=-1)
            target_joint = self._joint(st.target, next_obs, a_star, next_state_g)
            y = reward + cfg.gamma * (1.0 - done) * target_joint

            def loss_fn(p):
                joint = self._joint(p, obs, actions, state_g)
                # huber: the QMIX mixer's abs-weight hypernet amplifies
                # squared-error outliers into value blow-ups
                return optax.huber_loss(
                    joint, jax.lax.stop_gradient(y), delta=10.0
                ).mean()

            loss, grads = jax.value_and_grad(loss_fn)(st.params)
            updates, opt_state = self.opt.update(grads, st.opt_state)
            params = optax.apply_updates(st.params, updates)
            target = soft_update(st.target, params, cfg.tau)
            return MixState(params, target, opt_state), loss

        return update


# ----------------------------------------------------------------- MAPPO
@dataclasses.dataclass
class MappoConfig:
    n_agents: int = 3
    obs_dim: int = 4
    state_dim: int = 12
    num_actions: int = 5
    gamma: float = 0.95
    gae_lambda: float = 0.95
    clip: float = 0.2
    ent_coef: float = 0.01
    lr: float = 5e-4
    seed: int = 0


class MappoState(NamedTuple):
    actor: dict
    critic: dict
    actor_opt: tuple
    critic_opt: tuple


class MappoAgent:
    """Per-agent shared-parameter actor + centralized critic (MAPPO)."""

    def __init__(self, cfg: MappoConfig = MappoConfig()):
        self.cfg = cfg
        self.actor = AgentQNet(cfg.num_actions)  # logits head
        self.critic = MLP(1)
        self.actor_opt = optax.adam(cfg.lr)
        self.critic_opt = optax.adam(cfg.lr)

    def init(self) -> MappoState:
        cfg = self.cfg
        key = jax.random.PRNGKey(cfg.seed)
        a = self.actor.init(key, jnp.zeros((1, cfg.n_agents, cfg.obs_dim)))
        c = self.critic.init(key, jnp.zeros((1, cfg.state_dim)))
        return MappoState(a, c, self.actor_opt.init(a), self.critic_opt.init(c))

    def act(self, st: MappoState, obs, key):
        logits = self.actor.apply(st.actor, obs)  # [B, n, A]
        actions = jax.random.categorical(key, logits)
        logp = jax.nn.log_softmax(logits)
        chosen = jnp.take_along_axis(logp, actions[..., None], axis=-1)[..., 0]
        return actions, chosen.sum(axis=-1)  # joint log prob

    def value(self, st: MappoState, state_g):
        return self.critic.apply(st.critic, state_g)[..., 0]

    def make_update(self):
        cfg = self.cfg

        @jax.jit
        def update(st: MappoState, obs, actions, old_logp, adv, returns, state_g):
            adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)

            def actor_loss(ap):
                logits = self.actor.apply(ap, obs)
                logp_all = jax.nn.log_softmax(logits)
                logp = jnp.take_along_axis(logp_all, actions[..., None], axis=-1)[
                    ..., 0
                ].sum(axis=-1)
                ratio = jnp.exp(logp - old_logp)
                s1 = ratio * adv_n
                s2 = jnp.clip(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv_n
                ent = -(jnp.exp(logp_all) * logp_all).sum(-1).mean()
                return -jnp.minimum(s1, s2).mean() - cfg.ent_coef * ent

            def critic_loss(cp):
                v = self.critic.apply(cp, state_g)[..., 0]
                return ((v - returns) ** 2).mean()

            al, ag = jax.value_and_grad(actor_loss)(st.actor)
            cl, cg = jax.value_and_grad(critic_loss)(st.critic)
            au, actor_opt = self.actor_opt.update(ag, st.actor_opt)
            cu, critic_opt = self.critic_opt.update(cg, st.critic_opt)
            return (
                MappoState(
                    optax.apply_updates(st.actor, au),
                    optax.apply_updates(st.critic, cu),
                    actor_opt,
                    critic_opt,
                ),
                {"actor_loss": al, "critic_loss": cl},
            )

        return update


# ---------------------------------------------------------------- MADDPG
@dataclasses.dataclass
class MaddpgConfig:
    n_agents: int = 2
    obs_dim: int = 4
    act_dim: int = 2
    max_action: float = 1.0
    gamma: float = 0.95
    tau: float = 0.01
    lr: float = 1e-3
    seed: int = 0


class MaddpgState(NamedTuple):
    actors: dict  # stacked per-agent params (leading axis n_agents)
    actors_target: dict
    critics: dict
    critics_target: dict
    actor_opt: tuple
    critic_opt: tuple


class MaddpgAgent:
    """Per-agent deterministic actors + per-agent centralized critics over
    (all obs, all actions) — vmapped over the agent axis."""

    def __init__(self, cfg: MaddpgConfig = MaddpgConfig()):
        self.cfg = cfg
        self.actor = MLP(cfg.act_dim, out_scale=cfg.max_action, tanh_out=True)
        self.critic = MLP(1)
        self.actor_opt = optax.adam(cfg.lr)
        self.critic_opt = optax.adam(cfg.lr)

    def init(self) -> MaddpgState:
        cfg = self.cfg
        keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.n_agents)
        obs = jnp.zeros((1, cfg.obs_dim))
        joint = jnp.zeros((1, cfg.n_agents * (cfg.obs_dim + cfg.act_dim)))
        actors = jax.vmap(lambda k: self.actor.init(k, obs))(keys)
        critics = jax.vmap(lambda k: self.critic.init(k, joint))(keys)
        return MaddpgState(
            actors, actors, critics, critics,
            self.actor_opt.init(actors), self.critic_opt.init(critics),
        )

    def act(self, st: MaddpgState, obs):
        """obs [B, n, O] -> actions [B, n, A] (each agent its own actor)."""
        return jnp.swapaxes(
            jax.vmap(self.actor.apply, in_axes=(0, 1), out_axes=0)(st.actors, obs),
            0, 1,
        )

    def make_update(self):
        cfg = self.cfg

        def joint_feat(obs, act):
            b = obs.shape[0]
            return jnp.concatenate([obs.reshape(b, -1), act.reshape(b, -1)], axis=1)

        @jax.jit
        def update(st: MaddpgState, obs, act, reward, next_obs, done):
            """obs/next_obs [B, n, O]; act [B, n, A]; reward [B, n]."""
            next_act = self.act(st._replace(actors=st.actors_target), next_obs)
            jf_next = joint_feat(next_obs, next_act)
            q_next = jnp.swapaxes(
                jax.vmap(self.critic.apply, in_axes=(0, None))(
                    st.critics_target, jf_next
                )[..., 0],
                0, 1,
            )  # [B, n]
            y = reward + cfg.gamma * (1.0 - done[:, None]) * q_next

            def critic_loss(cp):
                q = jnp.swapaxes(
                    jax.vmap(self.critic.apply, in_axes=(0, None))(
                        cp, joint_feat(obs, act)
                    )[..., 0],
                    0, 1,
                )
                return ((q - jax.lax.stop_gradient(y)) ** 2).mean()

            cl, cg = jax.value_and_grad(critic_loss)(st.critics)
            cu, critic_opt = self.critic_opt.update(cg, st.critic_opt)
            critics = optax.apply_updates(st.critics, cu)

            def actor_loss(ap):
                my_act = jnp.swapaxes(
                    jax.vmap(self.actor.apply, in_axes=(0, 1), out_axes=0)(ap, obs),
                    0, 1,
                )
                jf = joint_feat(obs, my_act)
                q = jax.vmap(self.critic.apply, in_axes=(0, None))(critics, jf)[..., 0]
                return -q.mean()

            al, ag = jax.value_and_grad(actor_loss)(st.actors)
            au, actor_opt = self.actor_opt.update(ag, st.actor_opt)
            actors = optax.apply_updates(st.actors, au)
            return (
                MaddpgState(
                    actors,
                    soft_update(st.actors_target, actors, cfg.tau),
                    critics,
                    soft_update(st.critics_target, critics, cfg.tau),
                    actor_opt,
                    critic_opt,
                ),
                {"critic_loss": cl, "actor_loss": al},
            )

        return update
