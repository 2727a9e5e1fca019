"""RUN-CSP: recurrent message-passing network for binary MaxCSP.

Reference counterpart: `rlsolver/methods/RUNCSP/` — the repo's only
TensorFlow-1.x component (`model.py:198-520`): per-variable LSTM states,
per-relation message networks over clause index tensors, degree-normalized
aggregation, soft assignments, and a violation-probability loss summed over
message-passing iterations; `util.py:8-74` defines the constraint-language
formalism (characteristic 0/1 matrices per relation) with builders for
coloring/maxcut (NEQ), MIS (NAND), and max-2-SAT; `train_*.py` /
`evaluate_*.py` wire per-problem entry points with boosted prediction.

JAX redesign: clauses per relation live in padded [n_r, 2] index arrays;
one training step unrolls T message-passing iterations inside jit with
`segment_sum` aggregation; normalization is LayerNorm (BatchNorm inside an
unrolled RNN is an accelerator anti-pattern); boosted prediction = vmap over
parallel random initial states.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax


# ------------------------------------------------------- constraint language
@dataclasses.dataclass(frozen=True)
class ConstraintLanguage:
    """domain_size + relation name -> allowed (u, v) value pairs."""

    domain_size: int
    relations: Dict[str, Tuple[Tuple[int, int], ...]]

    def matrices(self) -> Dict[str, np.ndarray]:
        out = {}
        for name, pairs in self.relations.items():
            m = np.zeros((self.domain_size, self.domain_size), np.float32)
            for a, b in pairs:
                m[a, b] = 1.0
            out[name] = m
        return out

    @staticmethod
    def coloring(d: int) -> "ConstraintLanguage":
        pairs = tuple((a, b) for a in range(d) for b in range(d) if a != b)
        return ConstraintLanguage(d, {"NEQ": pairs})

    @staticmethod
    def maxcut() -> "ConstraintLanguage":
        return ConstraintLanguage(2, {"NEQ": ((0, 1), (1, 0))})

    @staticmethod
    def mis() -> "ConstraintLanguage":
        return ConstraintLanguage(2, {"NAND": ((0, 0), (0, 1), (1, 0))})

    @staticmethod
    def max2sat() -> "ConstraintLanguage":
        """Clause (l1 or l2) with per-literal polarity encoded in the
        relation: OR_pn = (x1 or not x2), etc."""
        return ConstraintLanguage(
            2,
            {
                "OR_pp": ((0, 1), (1, 0), (1, 1)),
                "OR_pn": ((0, 0), (1, 0), (1, 1)),
                "OR_np": ((0, 0), (0, 1), (1, 1)),
                "OR_nn": ((0, 0), (0, 1), (1, 0)),
            },
        )


@dataclasses.dataclass(frozen=True)
class CSPInstance:
    language: ConstraintLanguage
    num_vars: int
    clauses: Dict[str, np.ndarray]  # relation -> [n_r, 2] int32

    @property
    def num_clauses(self) -> int:
        return sum(int(c.shape[0]) for c in self.clauses.values())

    def degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_vars, np.int64)
        for c in self.clauses.values():
            np.add.at(deg, c.reshape(-1), 1)
        return deg

    def count_conflicts(self, assignment: np.ndarray) -> int:
        """Host twin of the device violation count (`util.py:105`)."""
        mats = self.language.matrices()
        total = 0
        for r, c in self.clauses.items():
            m = mats[r]
            for a, b in c:
                total += int(m[assignment[a], assignment[b]] == 0)
        return total

    @staticmethod
    def generate_random(
        num_vars: int,
        num_clauses: int,
        language: ConstraintLanguage,
        seed: int = 0,
    ) -> "CSPInstance":
        rng = np.random.RandomState(seed)
        names = list(language.relations.keys())
        rel = rng.choice(len(names), num_clauses)
        pairs = np.stack(
            [rng.choice(num_vars, 2, replace=False) for _ in range(num_clauses)]
        ).astype(np.int32)
        clauses = {
            n: pairs[rel == i]
            if (rel == i).any()
            else np.zeros((0, 2), np.int32)
            for i, n in enumerate(names)
        }
        return CSPInstance(language, num_vars, clauses)

    @staticmethod
    def from_graph(graph, language: ConstraintLanguage, relation: str) -> "CSPInstance":
        """Graph -> all edges under one relation (`graph_to_csp_instance`)."""
        edges = graph.edges.astype(np.int32)
        return CSPInstance(language, graph.num_nodes, {relation: edges})

    @staticmethod
    def generate_xu(
        num_vars: int,
        domain: int = 3,
        density: float = 2.0,
        seed: int = 0,
    ) -> Tuple["CSPInstance", np.ndarray]:
        """Forced-satisfiable hard coloring instance, Xu/Model-RB style
        (`RUNCSP/generate_xu_instances.py` capability): plant a hidden
        assignment, then add `density * n * ln(n)` NEQ constraints only
        between differently-assigned variables — satisfiable by
        construction, hard near the phase-transition density.

        Returns (instance, hidden assignment)."""
        rng = np.random.RandomState(seed)
        hidden = rng.randint(0, domain, num_vars)
        num_clauses = int(density * num_vars * max(1.0, np.log(num_vars)))
        pairs = set()
        tries = 0
        while len(pairs) < num_clauses and tries < 50 * num_clauses:
            tries += 1
            a, b = rng.randint(0, num_vars, 2)
            if a == b or hidden[a] == hidden[b]:
                continue
            pairs.add((min(a, b), max(a, b)))
        edges = np.asarray(sorted(pairs), np.int32)
        lang = ConstraintLanguage.coloring(domain)
        return CSPInstance(lang, num_vars, {"NEQ": edges}), hidden


# ---------------------------------------------------------------------- model
class RunCspNetwork(nn.Module):
    """One message-passing update + readout (applied T times)."""

    domain_size: int
    state_size: int = 64
    relation_names: Sequence[str] = ()

    @nn.compact
    def __call__(self, h, c, phi, clauses, degrees):
        """h/c: LSTM states [V, S]; phi: soft assignments [V, D];
        clauses: relation -> [n_r, 2]; degrees: [V, 1]."""
        v = h.shape[0]
        msg = jnp.zeros((v, self.state_size))
        for r in self.relation_names:
            idx = clauses[r]
            if idx.shape[0] == 0:
                continue
            left, right = idx[:, 0], idx[:, 1]
            # directional messages from each endpoint's soft assignment and
            # state (the reference's per-relation Message_Network)
            feat_l = jnp.concatenate([h[left], phi[left]], axis=1)
            feat_r = jnp.concatenate([h[right], phi[right]], axis=1)
            m_to_right = nn.Dense(self.state_size, name=f"{r}_lr")(feat_l)
            m_to_left = nn.Dense(self.state_size, name=f"{r}_rl")(feat_r)
            msg = msg.at[right].add(m_to_right)
            msg = msg.at[left].add(m_to_left)
        msg = msg / jnp.maximum(degrees, 1.0)
        msg = nn.LayerNorm(name="norm")(msg)
        (h, c), _ = nn.OptimizedLSTMCell(self.state_size, name="lstm")((h, c), msg)
        logits = nn.Dense(self.domain_size, use_bias=False, name="out")(h)
        phi = jax.nn.softmax(logits, axis=-1)
        return h, c, phi, logits


@dataclasses.dataclass
class RunCspConfig:
    state_size: int = 64
    iterations: int = 16
    lr: float = 1e-3
    epochs: int = 50
    discount: float = 0.95  # later iterations weighted higher
    seed: int = 0


class RunCspSolver:
    """Train/predict harness for one constraint language."""

    def __init__(self, language: ConstraintLanguage, cfg: RunCspConfig = RunCspConfig()):
        self.language = language
        self.cfg = cfg
        self.mats = {
            r: jnp.asarray(m) for r, m in language.matrices().items()
        }
        self.model = RunCspNetwork(
            language.domain_size, cfg.state_size, tuple(language.relations.keys())
        )

    def _device_instance(self, inst: CSPInstance):
        clauses = {r: jnp.asarray(c) for r, c in inst.clauses.items()}
        degrees = jnp.asarray(inst.degrees(), jnp.float32)[:, None]
        return clauses, degrees

    def _unroll(self, params, key, inst_dev, num_vars):
        clauses, degrees = inst_dev
        h = jax.random.normal(key, (num_vars, self.cfg.state_size)) * 0.1
        c = jnp.zeros_like(h)
        phi = jnp.full((num_vars, self.language.domain_size), 1.0 / self.language.domain_size)
        phis = []
        for _ in range(self.cfg.iterations):
            h, c, phi, _ = self.model.apply(params, h, c, phi, clauses, degrees)
            phis.append(phi)
        return phis

    def _loss(self, params, key, inst_dev, num_vars):
        clauses, _ = inst_dev
        phis = self._unroll(params, key, inst_dev, num_vars)
        total = 0.0
        weight_sum = 0.0
        for t, phi in enumerate(phis):
            w = self.cfg.discount ** (len(phis) - 1 - t)
            viol = 0.0
            for r, idx in clauses.items():
                if idx.shape[0] == 0:
                    continue
                m = self.mats[r]
                p_l, p_r = phi[idx[:, 0]], phi[idx[:, 1]]
                sat_p = jnp.einsum("ed,df,ef->e", p_l, m, p_r)
                viol = viol + jnp.sum(-jnp.log(jnp.clip(sat_p, 1e-8)))
            total = total + w * viol
            weight_sum += w
        return total / weight_sum

    def init_params(self, inst: CSPInstance):
        inst_dev = self._device_instance(inst)
        key = jax.random.PRNGKey(self.cfg.seed)
        clauses, degrees = inst_dev
        h = jnp.zeros((inst.num_vars, self.cfg.state_size))
        phi = jnp.full((inst.num_vars, self.language.domain_size), 0.5)
        return self.model.init(key, h, jnp.zeros_like(h), phi, clauses, degrees)

    def train(self, instances: List[CSPInstance]):
        """Train on a set of instances (uniform round-robin)."""
        params = self.init_params(instances[0])
        opt = optax.adam(self.cfg.lr)
        opt_state = opt.init(params)
        key = jax.random.PRNGKey(self.cfg.seed + 1)

        # one jitted step per distinct clause-shape signature
        step_cache = {}

        def make_step(inst_dev, num_vars):
            @jax.jit
            def step(params, opt_state, key):
                loss, grads = jax.value_and_grad(self._loss)(
                    params, key, inst_dev, num_vars
                )
                updates, opt_state = opt.update(grads, opt_state, params)
                return optax.apply_updates(params, updates), opt_state, loss

            return step

        history = []
        for epoch in range(self.cfg.epochs):
            for i, inst in enumerate(instances):
                sig = (i,)
                if sig not in step_cache:
                    step_cache[sig] = make_step(
                        self._device_instance(inst), inst.num_vars
                    )
                key, k = jax.random.split(key)
                params, opt_state, loss = step_cache[sig](params, opt_state, k)
            history.append(float(loss))
        return params, history

    def predict(self, params, inst: CSPInstance, key=None) -> np.ndarray:
        key = key if key is not None else jax.random.PRNGKey(0)
        phis = self._unroll(
            params, key, self._device_instance(inst), inst.num_vars
        )
        return np.asarray(jnp.argmax(phis[-1], axis=-1))

    def boosted_predict(
        self, params, inst: CSPInstance, num_boosts: int = 8
    ) -> Tuple[np.ndarray, int]:
        """Run `num_boosts` random initializations, keep the assignment with
        fewest conflicts (`RUN_CSP.boosted_predict` capability)."""
        best, best_conf = None, None
        for i in range(num_boosts):
            a = self.predict(params, inst, jax.random.PRNGKey(100 + i))
            conf = inst.count_conflicts(a)
            if best_conf is None or conf < best_conf:
                best, best_conf = a, conf
        return best, best_conf
