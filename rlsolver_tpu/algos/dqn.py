"""DQN for Pattern-I node-flip MDPs (S2V-DQN / ECO-DQN / PECO).

Capability-parity rebuild of the reference DQN agent
(`rlsolver/methods/ECO_S2V/src/agents/dqn.py:28-619`, vectorized variant
`dqn_PECO.py`): double-DQN targets, epsilon-greedy exploration with
allowed-action masking, a replay buffer, periodic target-network syncs, and
periodic greedy evaluation. Accelerator-first differences:

  * the replay buffer is a fixed-size ring of device arrays (a pytree), not
    python tuples (`src/agents/util.py:33`); adds and samples are jitted;
  * act / env.step / train_step are three jitted programs; the python loop
    only orchestrates and logs;
  * the vectorized env adds `num_envs` transitions per step (PECO's design),
    so the reference's "sample on one device, train on the other"
    split (`dqn_two_devices.py`) is unnecessary — one SPMD program does both.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.envs.spin_system import (
    SpinSystemConfig,
    SpinSystemEnv,
    SpinSystemParams,
    SpinSystemState,
)
from rlsolver_tpu.models.mpnn import MPNN


class ReplayBuffer(NamedTuple):
    """Fixed-capacity transition ring on device. capacity % add_size == 0."""

    obs: jax.Array  # [cap, N, obs]
    action: jax.Array  # [cap] int32
    reward: jax.Array  # [cap] f32
    next_obs: jax.Array  # [cap, N, obs]
    done: jax.Array  # [cap] bool
    gidx: jax.Array  # [cap] int32, which training instance the transition
    # came from (multi-graph distribution training; the reference stores
    # the adjacency inside each buffered observation, `mpnn.py:53-55` —
    # here one index replaces an [N, N] copy per transition)
    ptr: jax.Array  # int32, next write slot
    size: jax.Array  # int32, filled entries

    @staticmethod
    def create(capacity: int, num_nodes: int, num_obs: int) -> "ReplayBuffer":
        return ReplayBuffer(
            obs=jnp.zeros((capacity, num_nodes, num_obs), jnp.float32),
            action=jnp.zeros((capacity,), jnp.int32),
            reward=jnp.zeros((capacity,), jnp.float32),
            next_obs=jnp.zeros((capacity, num_nodes, num_obs), jnp.float32),
            done=jnp.zeros((capacity,), bool),
            gidx=jnp.zeros((capacity,), jnp.int32),
            ptr=jnp.int32(0),
            size=jnp.int32(0),
        )

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]


def buffer_add(
    buf: ReplayBuffer, obs, action, reward, next_obs, done, gidx=None
) -> ReplayBuffer:
    """Append a batch of transitions (batch size must divide capacity)."""
    b = obs.shape[0]
    cap = buf.obs.shape[0]
    start = buf.ptr  # multiple of b by construction
    if gidx is None:
        gidx = jnp.zeros((b,), jnp.int32)
    else:
        gidx = jnp.broadcast_to(jnp.asarray(gidx, jnp.int32), (b,))
    return ReplayBuffer(
        obs=jax.lax.dynamic_update_slice(buf.obs, obs, (start, 0, 0)),
        action=jax.lax.dynamic_update_slice(buf.action, action.astype(jnp.int32), (start,)),
        reward=jax.lax.dynamic_update_slice(buf.reward, reward, (start,)),
        next_obs=jax.lax.dynamic_update_slice(buf.next_obs, next_obs, (start, 0, 0)),
        done=jax.lax.dynamic_update_slice(buf.done, done, (start,)),
        gidx=jax.lax.dynamic_update_slice(buf.gidx, gidx, (start,)),
        ptr=(buf.ptr + b) % cap,
        size=jnp.minimum(buf.size + b, cap),
    )


def buffer_sample(buf: ReplayBuffer, key: jax.Array, batch_size: int):
    idx = jax.random.randint(key, (batch_size,), 0, buf.size)
    return (
        buf.obs[idx],
        buf.action[idx],
        buf.reward[idx],
        buf.next_obs[idx],
        buf.done[idx],
        buf.gidx[idx],
    )


@dataclasses.dataclass
class DQNConfig:
    features: int = 64
    n_layers: int = 3
    lr: float = 1e-4
    gamma: float = 0.95  # reference train_ECO.py:38
    buffer_capacity: int = 2**13
    batch_size: int = 64
    update_frequency: int = 4  # env steps between SGD steps
    target_update_frequency: int = 1000
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 10_000
    learning_starts: int = 512  # transitions before training
    seed: int = 0
    # MPNN compute dtype — jnp.bfloat16 is the reference's use_tensor_core
    # fp16 path (`networks/mpnn.py:55-58`) on the tensor cores
    dtype: jnp.dtype = jnp.float32


class DQNAgent:
    """MPNN Q-network + double-DQN training over a SpinSystemEnv."""

    def __init__(self, env: SpinSystemEnv, cfg: DQNConfig = DQNConfig()):
        self.env = env
        self.cfg = cfg
        self.model = MPNN(
            features=cfg.features, n_layers=cfg.n_layers, dtype=cfg.dtype
        )
        self.optimizer = optax.adam(cfg.lr)
        n = env.num_nodes
        num_obs = env.config.num_observables

        def act(params, obs, adj, mask, key, eps):
            """epsilon-greedy actions [B] with allowed-action masking."""
            q = self.model.apply(params, obs, adj)  # [B, N]
            q = jnp.where(mask, q, -jnp.inf)
            greedy = jnp.argmax(q, axis=-1)
            k1, k2 = jax.random.split(key)
            # uniform over allowed actions
            logits = jnp.where(mask, 0.0, -jnp.inf)
            random_a = jax.random.categorical(k1, logits, axis=-1)
            explore = jax.random.uniform(k2, greedy.shape) < eps
            return jnp.where(explore, random_a, greedy)

        def train_step(params, target_params, opt_state, batch, adj):
            # adj: [N, N] shared, or [B, N, N] per-sample (multi-graph
            # replay — each transition evaluated against its own instance)
            obs, action, reward, next_obs, done = batch[:5]

            def loss_fn(p):
                q = self.model.apply(p, obs, adj)
                q_a = jnp.take_along_axis(q, action[:, None], axis=1)[:, 0]
                # double DQN: online argmax, target evaluate
                next_q_online = self.model.apply(p, next_obs, adj)
                next_a = jnp.argmax(next_q_online, axis=-1)
                next_q_target = self.model.apply(target_params, next_obs, adj)
                next_v = jnp.take_along_axis(next_q_target, next_a[:, None], axis=1)[:, 0]
                y = reward + cfg.gamma * (1.0 - done.astype(jnp.float32)) * next_v
                return jnp.mean((q_a - jax.lax.stop_gradient(y)) ** 2)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = self.optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        self._act = jax.jit(act)
        self._train_step = jax.jit(train_step)
        self._env_step = jax.jit(env.step)
        self._env_reset = jax.jit(env.reset)

    def init_params(self, key: jax.Array, params_env: SpinSystemParams):
        b = self.env.config.num_envs
        dummy_obs = jnp.zeros(
            (b, self.env.num_nodes, self.env.config.num_observables), jnp.float32
        )
        return self.model.init(key, dummy_obs, params_env.adj)

    def epsilon(self, step: int) -> float:
        cfg = self.cfg
        frac = min(1.0, step / cfg.eps_decay_steps)
        return cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)

    # ------------------------------------------------------------- training
    def train(
        self,
        graph_sampler: Callable[[int], Graph],
        num_steps: int,
        eval_every: int = 0,
        eval_graphs: Optional[list] = None,
        select_best: bool = False,
        verbose: bool = False,
    ):
        """graph_sampler(i) -> Graph for episode i (distribution training).
        Returns (params, history dict). With `select_best` (and periodic
        eval configured), the returned params are the checkpoint with the
        highest mean validation cut — the reference's select-best-network
        protocol (`ECO_S2V/train_and_inference/select_best_neural_network.py:31`
        over `ValidationGraphGenerator` instances)."""
        cfg = self.cfg
        env = self.env
        key = jax.random.PRNGKey(cfg.seed)
        episode = 0
        graph = graph_sampler(episode)
        params_env = env.params_from_graph(graph)
        key, k_init, k_reset = jax.random.split(key, 3)
        params = self.init_params(k_init, params_env)
        target_params = params
        opt_state = self.optimizer.init(params)
        buf = ReplayBuffer.create(
            cfg.buffer_capacity, env.num_nodes, env.config.num_observables
        )
        add = jax.jit(buffer_add)
        sample = jax.jit(lambda b, k: buffer_sample(b, k, cfg.batch_size))

        state, obs = self._env_reset(params_env, k_reset)
        history = {"loss": [], "best_cut": [], "eval": []}
        best_eval, best_params = -np.inf, params
        train_steps = 0
        for step in range(num_steps):
            key, k_act, k_sample = jax.random.split(key, 3)
            mask = env.allowed_action_mask(state)
            actions = self._act(
                params, obs, params_env.adj, mask, k_act, self.epsilon(step)
            )
            state, next_obs, rew, done = self._env_step(params_env, state, actions)
            buf = add(buf, obs, actions, rew, next_obs, done)
            obs = next_obs

            if int(buf.size) >= cfg.learning_starts and step % cfg.update_frequency == 0:
                batch = sample(buf, k_sample)
                params, opt_state, loss = self._train_step(
                    params, target_params, opt_state, batch, params_env.adj
                )
                train_steps += 1
                if train_steps % max(1, cfg.target_update_frequency // cfg.update_frequency) == 0:
                    target_params = params
                history["loss"].append(float(loss))

            if bool(done[0]):
                history["best_cut"].append(float(jnp.max(state.best_score)))
                episode += 1
                graph = graph_sampler(episode)
                params_env = env.params_from_graph(graph)
                key, k_reset = jax.random.split(key)
                state, obs = self._env_reset(params_env, k_reset)
                if verbose:
                    print(
                        f"episode {episode:4d} step {step:6d} "
                        f"best_cut {history['best_cut'][-1]:9.1f} "
                        f"eps {self.epsilon(step):.3f}"
                    )

            if eval_every and eval_graphs and (step + 1) % eval_every == 0:
                score = np.mean([self.evaluate(params, g) for g in eval_graphs])
                history["eval"].append((step + 1, float(score)))
                if score > best_eval:
                    best_eval, best_params = float(score), params
                if verbose:
                    print(f"eval @ {step + 1}: avg best cut {score:.2f}")

        if select_best and history["eval"]:
            # final params also compete (a final eval may not align with
            # eval_every)
            score = np.mean([self.evaluate(params, g) for g in eval_graphs])
            if score > best_eval:
                best_eval, best_params = float(score), params
            return best_params, history
        return params, history

    # -------------------------------------------------- unified-runtime path
    def _build_loop_step(self, graph):
        """The whole act/step/replay/train/target-sync/episode-reset cycle
        as ONE jittable `step_fn(state) -> (state, metrics)` over a
        resumable state pytree, plus its initial state. Shared by
        `train_runner` (TrainLoop host loop) and `train_scan` (scan-chunked
        trainer with few dispatches).

        `graph` may be a single Graph (fixed-graph SingleGraphGenerator
        mode) or a LIST of same-size Graphs: the reference's
        RandomGraphGenerator distribution training (`train_ECO.py:24-31`,
        a fresh random graph every episode) — instances are stacked on a
        leading axis and the loop rotates to the next one at each episode
        boundary, so the whole multi-graph run stays one compiled program."""
        cfg = self.cfg
        env = self.env
        graphs = list(graph) if isinstance(graph, (list, tuple)) else [graph]
        num_graphs = len(graphs)
        stacked = jax.tree.map(
            lambda *xs: jnp.stack(xs),
            *[env.params_from_graph(g, hash_seed=i) for i, g in enumerate(graphs)],
        )

        def pe_at(idx):
            return jax.tree.map(lambda x: x[idx], stacked)

        params_env = pe_at(0)

        class DQNLoopState(NamedTuple):
            params: dict
            target_params: dict
            opt_state: optax.OptState
            buf: ReplayBuffer
            env_state: object
            obs: jax.Array
            key: jax.Array
            step_idx: jax.Array  # int32
            train_steps: jax.Array  # int32
            best_cut: jax.Array  # f32 running best over episodes
            graph_idx: jax.Array  # int32, current training instance

        target_sync = max(1, cfg.target_update_frequency // cfg.update_frequency)

        def step_fn(state: DQNLoopState):
            params_env = pe_at(state.graph_idx)
            key, k_act, k_sample, k_reset = jax.random.split(state.key, 4)
            frac = jnp.minimum(1.0, state.step_idx / cfg.eps_decay_steps)
            eps = cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)
            mask = env.allowed_action_mask(state.env_state)
            actions = self._act(
                state.params, state.obs, params_env.adj, mask, k_act, eps
            )
            env_state, next_obs, rew, done = env.step(
                params_env, state.env_state, actions
            )
            buf = buffer_add(
                state.buf, state.obs, actions, rew, next_obs, done,
                gidx=state.graph_idx,
            )

            do_train = jnp.logical_and(
                buf.size >= cfg.learning_starts,
                state.step_idx % cfg.update_frequency == 0,
            )

            def train_branch(args):
                params, target_params, opt_state, train_steps = args
                batch = buffer_sample(buf, k_sample, cfg.batch_size)
                if num_graphs > 1:
                    adj_b = stacked.adj[batch[5]]  # [batch, N, N] per sample
                else:
                    adj_b = params_env.adj
                params, opt_state, loss = self._train_step(
                    params, target_params, opt_state, batch[:5], adj_b
                )
                train_steps = train_steps + 1
                target_params = jax.tree.map(
                    lambda t, p: jnp.where(train_steps % target_sync == 0, p, t),
                    target_params,
                    params,
                )
                return params, target_params, opt_state, train_steps, loss

            def skip_branch(args):
                params, target_params, opt_state, train_steps = args
                return params, target_params, opt_state, train_steps, jnp.float32(0)

            params, target_params, opt_state, train_steps, loss = jax.lax.cond(
                do_train,
                train_branch,
                skip_branch,
                (state.params, state.target_params, state.opt_state,
                 state.train_steps),
            )

            best_cut = jnp.maximum(
                state.best_cut, jnp.max(env_state.best_score)
            )
            # episode boundary: rotate to the next training instance
            # (single-graph mode: num_graphs == 1, so this is a fixed-graph
            # reset — the reference's SingleGraphGenerator)
            ep_done = done[0]
            next_gidx = jnp.where(
                ep_done, (state.graph_idx + 1) % num_graphs, state.graph_idx
            )
            reset_state, reset_obs = env.reset(pe_at(next_gidx), k_reset)
            env_state = jax.tree.map(
                lambda r, c: jnp.where(ep_done, r, c), reset_state, env_state
            )
            obs = jnp.where(ep_done, reset_obs, next_obs)
            metrics = {"loss": loss, "best_cut": best_cut, "eps": eps}
            return (
                DQNLoopState(
                    params, target_params, opt_state, buf, env_state, obs,
                    key, state.step_idx + 1, train_steps, best_cut,
                    next_gidx,
                ),
                metrics,
            )

        key = jax.random.PRNGKey(cfg.seed)
        key, k_init, k_reset = jax.random.split(key, 3)
        params = self.init_params(k_init, params_env)
        env_state, obs = env.reset(params_env, k_reset)
        state = DQNLoopState(
            params=params,
            target_params=params,
            opt_state=self.optimizer.init(params),
            buf=ReplayBuffer.create(
                cfg.buffer_capacity, env.num_nodes, env.config.num_observables
            ),
            env_state=env_state,
            obs=obs,
            key=key,
            step_idx=jnp.int32(0),
            train_steps=jnp.int32(0),
            best_cut=jnp.float32(-jnp.inf),
            graph_idx=jnp.int32(0),
        )
        return step_fn, state

    def train_runner(
        self,
        graph: Graph,
        num_steps: int,
        run_dir: str = "runs/dqn",
        checkpoint_every: int = 0,
        resume: bool = False,
        log_every: int = 50,
    ):
        """Single-graph DQN through `train/runner.py:TrainLoop` —
        checkpoint/resume + metrics.jsonl + stop sentinel on the Pattern-I
        trainer (reference runtime capabilities: `AgentBase.py:280-299`,
        `run.py:130`). Returns (params, final_state)."""
        from rlsolver_tpu.train.runner import LoopConfig, TrainLoop

        step_fn, state = self._build_loop_step(graph)
        loop = TrainLoop(
            LoopConfig(
                run_dir=run_dir,
                total_steps=num_steps,
                log_every=log_every,
                checkpoint_every=checkpoint_every,
                resume=resume,
                samples_per_step=self.env.config.num_envs,
            ),
            step_fn,
        )
        state = loop.run(state)
        return state.params, state

    def train_scan(self, graph: Graph, num_steps: int, scan_chunk: int = 256):
        """Few-dispatch trainer: `scan_chunk` loop steps fused into one
        jitted `lax.scan` program, so a full training run is
        num_steps/scan_chunk dispatches instead of num_steps (the per-step
        host loop is bound by dispatch latency).
        Semantically identical to `train_runner` without the runtime edges.
        Returns (params, best_cut, final_state)."""
        step_fn, state = self._build_loop_step(graph)

        @jax.jit
        def chunk(state):
            def body(s, _):
                s, m = step_fn(s)
                return s, m["best_cut"]

            state, best = jax.lax.scan(body, state, None, length=scan_chunk)
            return state, best[-1]

        best_cut = -np.inf
        for _ in range(max(1, num_steps // scan_chunk)):
            state, best = chunk(state)
        best_cut = float(best)
        return state.params, best_cut, state

    def train_scan_select(
        self,
        graphs,
        num_steps: int,
        val_graphs: list,
        num_segments: int = 16,
        scan_chunk: int = 256,
        verbose: bool = False,
    ):
        """Reference-protocol distribution trainer: `graphs` is the rotating
        training-instance pool (fresh graph per episode — the reference's
        RandomGraphGenerator), training runs in `num_segments` segments, and
        after each segment the current params are scored by greedy rollout
        on `val_graphs`; the best-scoring checkpoint is returned
        (`ECO_S2V/train_and_inference/select_best_neural_network.py:31` over
        ValidationGraphGenerator instances). Segmented dispatch also keeps
        individual device programs short (see `algos/isco.py:MAX_SCAN_SEGMENT`).

        Returns (best_params, history) with history = list of
        (cumulative_steps, mean_val_cut)."""
        step_fn, state = self._build_loop_step(graphs)

        @jax.jit
        def chunk(state):
            def body(s, _):
                s, m = step_fn(s)
                return s, m["best_cut"]

            state, best = jax.lax.scan(body, state, None, length=scan_chunk)
            return state, best[-1]

        seg_chunks = max(1, num_steps // (num_segments * scan_chunk))
        best_score, best_params = -np.inf, state.params
        history = []
        for seg in range(num_segments):
            for _ in range(seg_chunks):
                state, _ = chunk(state)
            score = float(
                np.mean([self.evaluate_scan(state.params, g) for g in val_graphs])
            )
            steps_done = (seg + 1) * seg_chunks * scan_chunk
            history.append((steps_done, score))
            if score > best_score:
                best_score, best_params = score, state.params
            if verbose:
                print(
                    f"  segment {seg + 1}/{num_segments} "
                    f"({steps_done} loop steps): val cut {score:.1f}"
                    + (" *" if score == best_score else ""),
                    flush=True,
                )
        return best_params, history

    # ------------------------------------------------------------- inference
    def evaluate(
        self,
        params,
        graph: Graph,
        key: Optional[jax.Array] = None,
        num_envs: Optional[int] = None,
    ) -> float:
        """Greedy rollout on one graph over the vectorized envs; returns the
        best cut found (reference `__test_network_batched`,
        `ECO_S2V/util.py:90-353`).

        Chunked inference (`MINI_INFERENCE_ENVS`, reference
        `ECO_S2V/config.py:50-51`, `jumanji/.../inference.py:84-95`): when
        `num_envs` exceeds the env's compiled batch, runs
        ceil(num_envs / env.config.num_envs) sequential rollouts through the
        same compiled program — total parallelism without growing device memory."""
        env = self.env
        params_env = env.params_from_graph(graph)
        key = key if key is not None else jax.random.PRNGKey(0)
        chunks = max(1, -(-(num_envs or env.config.num_envs) // env.config.num_envs))
        best = -float("inf")
        for c in range(chunks):
            state, obs = self._env_reset(params_env, jax.random.fold_in(key, c))
            for _ in range(env.max_steps):
                mask = env.allowed_action_mask(state)
                actions = self._act(
                    params, obs, params_env.adj, mask, jax.random.PRNGKey(0), 0.0
                )
                state, obs, _, done = self._env_step(params_env, state, actions)
            best = max(best, float(jnp.max(state.best_score)))
        return best

    def evaluate_scan(
        self,
        params,
        graph: Graph,
        key: Optional[jax.Array] = None,
        num_restarts: int = 1,
    ) -> float:
        """`evaluate`, but the whole greedy rollout is one jitted
        `lax.scan` over max_steps — one dispatch per restart instead of
        max_steps of them (per-step host loops are bound by dispatch
        latency). `params_env` rides as a jit argument, so
        same-shape graphs share the compiled program."""
        env = self.env
        key = key if key is not None else jax.random.PRNGKey(0)

        if not hasattr(self, "_eval_rollout"):

            def rollout(params, params_env, k):
                state, obs = env.reset(params_env, k)

                def body(carry, _):
                    state, obs = carry
                    mask = env.allowed_action_mask(state)
                    actions = self._act(
                        params, obs, params_env.adj, mask, jax.random.PRNGKey(0), 0.0
                    )
                    state, obs, _, _ = env.step(params_env, state, actions)
                    return (state, obs), None

                (state, _), _ = jax.lax.scan(
                    body, (state, obs), None, length=env.max_steps
                )
                return jnp.max(state.best_score)

            self._eval_rollout = jax.jit(rollout)

        params_env = env.params_from_graph(graph)
        return max(
            float(self._eval_rollout(params, params_env, jax.random.fold_in(key, c)))
            for c in range(num_restarts)
        )
