"""REINFORCE baseline family + generic constructive-policy trainer.

Reference counterpart: the vendored rl4co subset's baseline zoo
(`rlsolver/methods/ECO_S2V/rl4co/models/rl/reinforce/baselines.py:18-292`)
and REINFORCE trainer (`.../reinforce/reinforce.py`): NoBaseline,
SharedBaseline (POMO mean over the multistart dim), ExponentialBaseline
(EMA of mean reward, beta=0.8), MeanBaseline (alias of exponential),
WarmupBaseline (convex ramp from an exponential baseline into the wrapped
one over n_epochs), CriticBaseline (learned value net, MSE-trained), and
RolloutBaseline (greedy rollouts of a frozen policy snapshot, adopted from
the candidate when a one-sided t-test on a held-out eval set is significant
at bl_alpha, `baselines.py:161-243`), looked up by name through
`get_reinforce_baseline` (`baselines.py:286`).

Accelerator-first redesign: baselines are pure functions over explicit pytree
state — `eval(state, rewards) -> (values, state)` runs inside the jitted
train step; `epoch_update(state, params, key)` is the host-side epoch
callback (the rollout baseline's t-test + snapshot swap). The generic
`train_reinforce` drives any constructive policy through a small adapter
protocol (sample_instances / init_params / rollout): `TSPAdapter` is the
AM/POMO attention policy (`models/attention_tsp.py`, rewards = negative
tour lengths), `S2VMaxcutAdapter` is the constructive S2V maxcut policy
(`models/s2v_policy.py`, rewards = cut values) — the reference's S2V model
zoo trained through the same baseline family.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax

from rlsolver_tpu.algos.am_pomo import rollout_pomo
from rlsolver_tpu.models.attention_tsp import AttentionTSP


class BaselineState(NamedTuple):
    """Union state for every baseline kind (unused leaves stay empty)."""

    ema: jax.Array  # [] exponential moving average
    steps: jax.Array  # [] int32 — for warmup ramp
    critic_params: Optional[dict] = None
    critic_opt: Optional[tuple] = None
    frozen_params: Optional[dict] = None  # rollout baseline policy snapshot
    frozen_mean: jax.Array = jnp.float32(0.0)  # its eval-set mean reward
    # WarmupBaseline keeps its own exponential EMA + ramp counter so the
    # inner baseline's (ema, steps) are never touched twice per eval
    # (reference WarmupBaseline holds a *separate* ExponentialBaseline
    # instance, `baselines.py:92-136`).
    warmup_ema: jax.Array = jnp.float32(0.0)
    warmup_steps: jax.Array = jnp.int32(0)


class _CriticNet(nn.Module):
    """Mean-pooled instance encoder -> scalar value (rl4co CriticNetwork)."""

    hidden: int = 128

    @nn.compact
    def __call__(self, nodes):  # [B, N, 2] -> [B]
        x = nn.Dense(self.hidden)(nodes)
        x = nn.relu(x)
        x = x.mean(axis=1)
        x = nn.relu(nn.Dense(self.hidden)(x))
        return nn.Dense(1)(x)[..., 0]


class Baseline:
    """Functional baseline: subclasses override eval/epoch_update/init."""

    name = "no"

    def init(self, key, model, params, sample_nodes) -> BaselineState:
        return BaselineState(jnp.float32(0.0), jnp.int32(0))

    def eval(
        self, state: BaselineState, rewards: jax.Array, nodes: jax.Array
    ) -> Tuple[jax.Array, BaselineState]:
        """rewards [B] or [B, P] -> (baseline values like rewards, state)."""
        return jnp.zeros_like(rewards), state

    def epoch_update(self, state, model, params, key) -> BaselineState:
        return state

    def critic_loss(self, state, rewards, nodes):
        """Extra loss term (critic baseline); 0 elsewhere."""
        return 0.0


class NoBaseline(Baseline):
    pass


class SharedBaseline(Baseline):
    """POMO: mean over the multistart dim (`baselines.py:56-60`)."""

    name = "shared"

    def eval(self, state, rewards, nodes):
        if rewards.ndim < 2:
            raise ValueError("shared baseline needs [batch, pomo] rewards")
        return jnp.mean(rewards, axis=1, keepdims=True), state


class ExponentialBaseline(Baseline):
    """v <- beta * v + (1 - beta) * mean(reward) (`baselines.py:63-82`)."""

    name = "exponential"

    def __init__(self, beta: float = 0.8):
        self.beta = beta

    def eval(self, state, rewards, nodes):
        m = jnp.mean(rewards)
        v = jnp.where(
            state.steps == 0, m, self.beta * state.ema + (1.0 - self.beta) * m
        )
        return (
            jnp.broadcast_to(v, rewards.shape),
            state._replace(ema=v, steps=state.steps + 1),
        )


def MeanBaseline(**kw) -> Baseline:
    """rl4co aliases mean -> exponential (`baselines.py:85-89`)."""
    return ExponentialBaseline(**kw)


class WarmupBaseline(Baseline):
    """Convex ramp from an exponential baseline into `inner` over
    `n_steps` updates (`baselines.py:92-136`, epoch-ramp reproduced at
    update granularity — this trainer has no dataset epochs)."""

    name = "warmup"

    def __init__(self, inner: Baseline, n_steps: int = 100, beta: float = 0.8):
        self.inner = inner
        self.beta = beta
        self.n_steps = n_steps

    def init(self, key, model, params, sample_nodes):
        return self.inner.init(key, model, params, sample_nodes)

    def eval(self, state, rewards, nodes):
        inner_v, state = self.inner.eval(state, rewards, nodes)
        m = jnp.mean(rewards)
        exp_v = jnp.where(
            state.warmup_steps == 0,
            m,
            self.beta * state.warmup_ema + (1.0 - self.beta) * m,
        )
        alpha = jnp.clip(
            state.warmup_steps.astype(jnp.float32) / self.n_steps, 0.0, 1.0
        )
        state = state._replace(
            warmup_ema=exp_v, warmup_steps=state.warmup_steps + 1
        )
        return alpha * inner_v + (1.0 - alpha) * exp_v, state

    def epoch_update(self, state, model, params, key):
        return self.inner.epoch_update(state, model, params, key)


class CriticBaseline(Baseline):
    """Learned value of the instance (`baselines.py:139-158`): an MSE term
    on the critic rides the policy loss; eval detaches."""

    name = "critic"

    def __init__(self, hidden: int = 128, lr: float = 1e-3):
        self.net = _CriticNet(hidden)
        self.optim = optax.adam(lr)

    def init(self, key, model, params, sample_nodes):
        cp = self.net.init(key, sample_nodes)
        return BaselineState(
            jnp.float32(0.0), jnp.int32(0), critic_params=cp,
            critic_opt=self.optim.init(cp),
        )

    def eval(self, state, rewards, nodes):
        v = self.net.apply(state.critic_params, nodes)  # [B]
        v = jax.lax.stop_gradient(v)
        if rewards.ndim == 2:
            v = v[:, None]
        return jnp.broadcast_to(v, rewards.shape), state._replace(
            steps=state.steps + 1
        )

    def update_critic(self, state, rewards, nodes) -> BaselineState:
        target = rewards.mean(axis=tuple(range(1, rewards.ndim)))

        def loss(cp):
            return jnp.mean((self.net.apply(cp, nodes) - target) ** 2)

        grads = jax.grad(loss)(state.critic_params)
        upd, opt = self.optim.update(grads, state.critic_opt)
        return state._replace(
            critic_params=optax.apply_updates(state.critic_params, upd),
            critic_opt=opt,
        )


class RolloutBaseline(Baseline):
    """Greedy rollout of a frozen policy snapshot (`baselines.py:161-243`):
    eval = frozen policy's greedy reward on the same instances; the epoch
    callback re-evaluates the candidate on a fixed eval set and adopts it
    when the improvement passes a one-sided t-test at `bl_alpha`.

    `model` may be an AttentionTSP module (legacy TSP path) or any
    PolicyAdapter (anything with a `.rollout(params, key, instances,
    greedy=)` returning (xs, logp, rewards)) — the zoo is policy-generic,
    matching rl4co's env-agnostic RolloutBaseline."""

    name = "rollout"

    def __init__(self, model, eval_nodes, bl_alpha: float = 0.05):
        self.model = model
        self.eval_nodes = eval_nodes  # held-out instances, [E, ...]
        self.bl_alpha = bl_alpha

    def _greedy_rewards(self, params, nodes, pomo=1):
        if hasattr(self.model, "rollout"):  # PolicyAdapter
            _, _, rewards = self.model.rollout(
                params, jax.random.PRNGKey(0), nodes, greedy=True
            )
            return rewards[:, 0] if rewards.ndim == 2 else rewards
        _, _, lengths = rollout_pomo(
            self.model, params, jax.random.PRNGKey(0), nodes, pomo_size=pomo,
            greedy=True,
        )
        return -lengths[:, 0]

    def init(self, key, model, params, sample_nodes):
        mean = self._greedy_rewards(params, self.eval_nodes).mean()
        return BaselineState(
            jnp.float32(0.0), jnp.int32(0), frozen_params=params,
            frozen_mean=mean,
        )

    def eval(self, state, rewards, nodes):
        v = self._greedy_rewards(state.frozen_params, nodes)  # [B]
        if rewards.ndim == 2:
            v = v[:, None]
        return jnp.broadcast_to(v, rewards.shape), state

    def epoch_update(self, state, model, params, key):
        cand = np.asarray(self._greedy_rewards(params, self.eval_nodes))
        base = np.asarray(self._greedy_rewards(state.frozen_params, self.eval_nodes))
        diff = cand - base
        if diff.mean() <= 0:
            return state
        # one-sided paired t-test (scipy-free): p = P(T_{n-1} > t)
        n = diff.shape[0]
        t = diff.mean() / max(diff.std(ddof=1) / np.sqrt(n), 1e-12)
        p = _t_sf(t, n - 1)
        if p < self.bl_alpha:
            return state._replace(
                frozen_params=params, frozen_mean=jnp.float32(cand.mean())
            )
        return state


def _t_sf(t: float, df: int) -> float:
    """Student-t survival function via the regularized incomplete beta
    (Abramowitz-Stegun continued fraction; no scipy in this image)."""
    x = df / (df + t * t)
    ib = _betainc(df / 2.0, 0.5, x)
    return 0.5 * ib if t > 0 else 1.0 - 0.5 * ib


def _betainc(a: float, b: float, x: float, iters: int = 200) -> float:
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    import math

    ln_front = (
        math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
        + a * math.log(x) + b * math.log1p(-x)
    )
    # Lentz continued fraction for I_x(a, b)
    f, c, d = 1.0, 1.0, 0.0
    for i in range(iters):
        m = i // 2
        if i == 0:
            num = 1.0
        elif i % 2 == 0:
            num = m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m))
        else:
            num = -(a + m) * (a + b + m) * x / ((a + 2 * m) * (a + 2 * m + 1))
        d = 1.0 + num * d
        d = 1.0 / (d if abs(d) > 1e-30 else 1e-30)
        c = 1.0 + num / (c if abs(c) > 1e-30 else 1e-30)
        f *= c * d
    front = math.exp(ln_front) / a
    val = front * (f - 1.0)
    # use the symmetry relation outside the convergent region
    if x > (a + 1.0) / (a + b + 2.0):
        return 1.0 - _betainc(b, a, 1.0 - x)
    return min(max(val, 0.0), 1.0)


_REGISTRY = {
    "no": lambda **kw: NoBaseline(),
    "shared": lambda **kw: SharedBaseline(),
    "exponential": lambda **kw: ExponentialBaseline(**kw),
    "mean": lambda **kw: MeanBaseline(**kw),
    "critic": lambda **kw: CriticBaseline(**kw),
}


def get_reinforce_baseline(name: str, **kw) -> Baseline:
    """Name -> baseline (`get_reinforce_baseline`, `baselines.py:286-292`).
    `warmup_<name>` wraps `<name>` in a warmup ramp; `rollout` needs the
    model + eval instances passed as kw."""
    if name == "rollout":
        return RolloutBaseline(**kw)
    if name.startswith("warmup_"):
        return WarmupBaseline(get_reinforce_baseline(name[len("warmup_"):], **kw))
    if name not in _REGISTRY:
        raise ValueError(f"unknown baseline {name!r}; one of {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)


# ------------------------------------------------------------------ trainer
@dataclasses.dataclass
class ReinforceConfig:
    num_cities: int = 20
    embed_dim: int = 64
    num_heads: int = 4
    num_layers: int = 2
    batch_size: int = 64
    pomo_size: int = 1  # 1 = plain REINFORCE; >1 = multistart
    num_steps: int = 100
    epoch_every: int = 20  # host epoch callback cadence (rollout t-test)
    lr: float = 1e-4
    ent_coef: float = 0.0  # entropy bonus (keeps constructive policies off
    # the zero-gradient one-hot boundary; 0 = reference rl4co behavior)
    seed: int = 0


class TSPAdapter:
    """AM attention policy over random euclidean TSP batches — the rl4co
    AttentionModel through the zoo; rewards are negative tour lengths."""

    def __init__(self, cfg: ReinforceConfig, instance_sampler=None):
        self.cfg = cfg
        self.model = AttentionTSP(cfg.embed_dim, cfg.num_heads, cfg.num_layers)
        self._sampler = instance_sampler

    def sample_instances(self, k):
        if self._sampler is not None:
            return self._sampler(k)
        return jax.random.uniform(k, (self.cfg.batch_size, self.cfg.num_cities, 2))

    def init_params(self, key, nodes0):
        dummy = jnp.zeros((1, 1), jnp.int32)
        mask = jnp.ones((1, 1, nodes0.shape[1]), bool)
        return self.model.init(key, nodes0[:1], dummy, dummy, mask, None)

    def rollout(self, params, key, nodes, greedy=False):
        tours, logp, lengths = rollout_pomo(
            self.model, params, key, nodes,
            pomo_size=1 if greedy else self.cfg.pomo_size, greedy=greedy,
        )
        return tours, logp, -lengths  # rewards [B, P]


class S2VMaxcutAdapter:
    """Constructive S2V maxcut policy through the zoo (the reference's
    `ECO_S2V/rl4co/models/zoo/S2V/` path): instances are batched dense
    adjacencies of a seeded graph distribution, the policy constructs a
    cut node-by-node (`models/s2v_policy.py`), rewards are cut values."""

    def __init__(
        self,
        cfg: ReinforceConfig,
        num_nodes: int = 64,
        graph_type=None,
        horizon: Optional[int] = None,
        pool_size: int = 64,
    ):
        from rlsolver_tpu.config import GraphType
        from rlsolver_tpu.models.s2v_policy import S2VConstructivePolicy

        self.cfg = cfg
        self.num_nodes = num_nodes
        self.graph_type = graph_type or GraphType.BA
        self.horizon = horizon or num_nodes // 2
        self.pool_size = pool_size
        self.model = S2VConstructivePolicy(cfg.embed_dim, cfg.num_layers)
        self._adj_pool: Optional[jax.Array] = None

    def _pool(self) -> jax.Array:
        """Seeded instance pool (generators are host-side networkx code, so
        sampling inside jit is impossible — pre-build and gather)."""
        if self._adj_pool is None:
            from rlsolver_tpu.core.generate import generate_graph

            adjs = [
                generate_graph(self.graph_type, self.num_nodes, seed=s)
                .adjacency_dense()
                for s in range(self.pool_size)
            ]
            self._adj_pool = jnp.asarray(np.stack(adjs))
        return self._adj_pool

    def sample_instances(self, k):
        ids = jax.random.randint(k, (self.cfg.batch_size,), 0, self.pool_size)
        return self._pool()[ids]

    def init_params(self, key, adj0):
        return self.model.init(key, adj0[:1])

    def rollout(self, params, key, adj, greedy=False):
        from rlsolver_tpu.models.s2v_policy import rollout_s2v_maxcut

        return rollout_s2v_maxcut(
            self.model, params, key, adj, horizon=self.horizon, greedy=greedy
        )  # (xs, logp [B], rewards [B])


def train_reinforce(
    baseline: Baseline,
    cfg: ReinforceConfig = ReinforceConfig(),
    instance_sampler: Optional[Callable[[jax.Array], jax.Array]] = None,
    adapter=None,
    optimizer=None,
):
    """Generic REINFORCE-with-baseline on any constructive policy adapter
    (rl4co `REINFORCE.shared_step` semantics). Default adapter is the
    AM/TSP policy; pass `S2VMaxcutAdapter` for the constructive maxcut
    policy. Returns (params, history with mean rewards; `mean_length`
    = -reward kept as the TSP-era alias)."""
    adapter = adapter or TSPAdapter(cfg, instance_sampler)
    if optimizer is None:
        optimizer = optax.chain(
            optax.clip_by_global_norm(1.0), optax.adam(cfg.lr)
        )
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init, k_bl = jax.random.split(key, 3)

    nodes0 = adapter.sample_instances(k_init)
    params = adapter.init_params(k_init, nodes0)
    opt_state = optimizer.init(params)
    bl_state = baseline.init(k_bl, adapter.model, params, nodes0)
    is_critic = isinstance(baseline, CriticBaseline)

    @jax.jit
    def step(params, opt_state, bl_state, k):
        k_data, k_roll = jax.random.split(k)
        nodes = adapter.sample_instances(k_data)

        def loss_fn(p):
            _, logp, rewards = adapter.rollout(p, k_roll, nodes)
            bl, new_state = baseline.eval(bl_state, rewards, nodes)
            advantage = jax.lax.stop_gradient(rewards - bl)
            loss = -jnp.mean(advantage * logp)
            if cfg.ent_coef:
                # -logp is an unbiased per-trajectory entropy estimate
                loss = loss - cfg.ent_coef * jnp.mean(-logp)
            return loss, (new_state, rewards, jnp.mean(rewards))

        (loss, (new_state, rewards, mean_r)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params)
        upd, opt_state = optimizer.update(grads, opt_state)
        params = optax.apply_updates(params, upd)
        if is_critic:
            new_state = baseline.update_critic(new_state, rewards, nodes)
        return params, opt_state, new_state, mean_r

    history = {"mean_length": [], "mean_reward": []}
    for i in range(cfg.num_steps):
        key, k = jax.random.split(key)
        params, opt_state, bl_state, mean_r = step(params, opt_state, bl_state, k)
        history["mean_reward"].append(float(mean_r))
        history["mean_length"].append(-float(mean_r))
        if cfg.epoch_every and (i + 1) % cfg.epoch_every == 0:
            key, k_ep = jax.random.split(key)
            bl_state = baseline.epoch_update(
                bl_state, adapter.model, params, k_ep
            )
    return params, history
