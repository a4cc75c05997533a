"""Vanilla + Reusable MCTS query optimizers (paper Sec. IV, Alg. 1-5, 10).

States are query plans; in the reusable optimizer states are *embeddings*
(Query2Vec vectors) held in a global node store shared across queries, and
actions are *configurable* co-optimization rules: selecting an action picks
the rule, then the rule is configured (heuristic narrowing + cost-model
scoring of candidate configs) for the concrete query — Sec. IV-B2.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import cost, ir
from repro_torch.core.rules import ALL_RULES
from repro_torch.core.rules.base import RuleConfig

ACTION_SPACE = ["R1-1", "R1-2", "R1-3", "R1-4-merge", "R1-4-split", "compact",
                "R2-1", "R2-3", "R3-1", "R3-2", "R3-3", "R4-1-split",
                "R4-1-fuse", "R4-1-unfuse", "R4-2", "R4-4"]

CostFn = Callable[[ir.Plan], float]


def _heuristic_narrow(action: str, plan: ir.Plan, cfgs: List[RuleConfig],
                      topk: int) -> List[RuleConfig]:
    """Paper: 'we first use heuristics, if available, to narrow the
    candidates, e.g. the matMul functions involving the top-k largest
    tensors'."""
    if action == "R3-1":
        def wbytes(c):
            fn = plan.registry.get(c.get("fn"))
            return -fn.graph.nodes[c.get("idx")].atom.param_bytes()
        cfgs = sorted(cfgs, key=wbytes)
    elif action == "compact":
        cfgs = sorted(cfgs, key=lambda c: c.get("capacity"))
    return cfgs[:topk]


def configure_action(plan: ir.Plan, catalog: ir.Catalog, action: str,
                     cost_fn: CostFn, topk: int = 4
                     ) -> Optional[Tuple[ir.Plan, RuleConfig]]:
    """Pick the best configuration of `action` for this plan (or None if the
    rule is inapplicable)."""
    rule = ALL_RULES[action]
    cfgs = rule.configs(plan, catalog)
    if not cfgs:
        return None
    cfgs = _heuristic_narrow(action, plan, cfgs, topk)
    best, best_cost = None, float("inf")
    for cfg in cfgs:
        try:
            cand = rule.apply(plan, catalog, cfg)
        except Exception:
            continue
        c = cost_fn(cand)
        if c < best_cost:
            best, best_cost, best_cfg = cand, c, cfg
    if best is None:
        return None
    return best, best_cfg


# ===========================================================================
# Vanilla MCTS (Alg. 1-4 + 10): fresh tree per query
# ===========================================================================

@dataclasses.dataclass
class _VNode:
    plan: ir.Plan
    cost: float
    parent: Optional["_VNode"] = None
    action: Optional[str] = None
    depth: int = 0
    n: int = 0
    r: float = 0.0
    children: Dict[str, "_VNode"] = dataclasses.field(default_factory=dict)
    untried: Optional[List[str]] = None
    dead: set = dataclasses.field(default_factory=set)

    def terminal(self, max_depth):
        return self.depth >= max_depth or (
            self.untried is not None and not self.untried and not self.children)


def _select_ucb(node: _VNode, c: float) -> _VNode:
    """Alg. 1: argmax r_i/n_i + c*sqrt(ln N / n_i)."""
    best, best_v = None, -float("inf")
    for ch in node.children.values():
        v = ch.r / max(ch.n, 1) + c * math.sqrt(math.log(max(node.n, 1)) / max(ch.n, 1))
        if v > best_v:
            best, best_v = ch, v
    return best


class VanillaMCTS:
    def __init__(self, catalog: ir.Catalog, cost_fn: Optional[CostFn] = None,
                 iterations: int = 40,
                 c: float = 0.7, max_depth: int = 6, rollout_depth: int = 3,
                 seed: int = 0, actions: Optional[List[str]] = None):
        self.catalog = catalog
        # default reward oracle: the shared plan_cost entry point (the same
        # oracle costed lowering scores its physical candidates with)
        self.cost_fn = cost_fn or (lambda p: cost.plan_cost(p, catalog))
        self.iterations = iterations
        self.c = c
        self.max_depth = max_depth
        self.rollout_depth = rollout_depth
        self.rng = random.Random(seed)
        self.actions = actions or ACTION_SPACE

    def _expandable(self, node: _VNode) -> List[str]:
        if node.untried is None:
            node.untried = [a for a in self.actions if a not in node.dead]
        return node.untried

    def _take(self, node: _VNode, action: str) -> Optional[_VNode]:
        res = configure_action(node.plan, self.catalog, action, self.cost_fn)
        if res is None:
            node.dead.add(action)
            return None
        plan2, _ = res
        child = _VNode(plan=plan2, cost=self.cost_fn(plan2), parent=node,
                       action=action, depth=node.depth + 1)
        node.children[action] = child
        return child

    def _rollout(self, node: _VNode) -> _VNode:
        """Alg. 3: random actions to a terminal (or budget)."""
        cur = node
        for _ in range(self.rollout_depth):
            acts = list(self.actions)
            self.rng.shuffle(acts)
            nxt = None
            for a in acts:
                if a in cur.dead or a in cur.children:
                    continue
                nxt = self._take(cur, a)
                if nxt is not None:
                    break
            if nxt is None:
                break
            cur = nxt
        return cur

    def optimize(self, plan: ir.Plan) -> Tuple[ir.Plan, Dict]:
        root = _VNode(plan=plan, cost=self.cost_fn(plan))
        best_plan, best_cost = plan, root.cost
        for _ in range(self.iterations):
            node = root
            # selection: descend fully-expanded nodes (Alg. 10)
            while not node.terminal(self.max_depth):
                untried = self._expandable(node)
                if untried:
                    a = self.rng.choice(untried)
                    untried.remove(a)
                    child = self._take(node, a)
                    if child is None:
                        continue
                    node = self._rollout(child)
                    break
                sel = _select_ucb(node, self.c)
                if sel is None:
                    break
                node = sel
            # reward (paper: cost_root - cost_T, normalized here)
            reward = (root.cost - node.cost) / max(root.cost, 1e-12)
            if node.cost < best_cost:
                best_plan, best_cost = node.plan, node.cost
            # backpropagate (Alg. 4)
            cur = node
            while cur is not None:
                cur.n += 1
                cur.r += reward
                cur = cur.parent
        return best_plan, {"root_cost": root.cost, "best_cost": best_cost,
                           "speedup": root.cost / max(best_cost, 1e-12)}


# ===========================================================================
# Reusable MCTS (Alg. 5): embedding-keyed global node store
# ===========================================================================

@dataclasses.dataclass
class _RNode:
    nid: int
    embed: np.ndarray                      # normalized 393-d state embedding
    n: int = 0
    r: float = 0.0
    children: Dict[str, int] = dataclasses.field(default_factory=dict)
    dead: set = dataclasses.field(default_factory=set)
    untried: Optional[List[str]] = None
    # best known rule chain from this state (as a search root) + the
    # root-relative speedup it achieved: the warm-start replay sketch
    best_seq: Tuple[str, ...] = ()
    best_gain: float = 1.0

    def storage_bytes(self) -> int:
        return (self.embed.nbytes + 64 + 16 * len(self.children)
                + 8 * len(self.best_seq))


class NodeIndex:
    """Exact cosine NN index over node embeddings (the paper uses Faiss;
    index sizes here are small enough for the exact search)."""

    def __init__(self):
        self._embs: List[np.ndarray] = []
        self._ids: List[int] = []
        self._mat: Optional[np.ndarray] = None

    def add(self, nid: int, emb: np.ndarray):
        self._embs.append(emb.astype(np.float32))
        self._ids.append(nid)
        self._mat = None

    def search(self, emb: np.ndarray) -> Tuple[int, float]:
        if not self._embs:
            return -1, -1.0
        if self._mat is None:
            self._mat = np.stack(self._embs)
        sims = self._mat @ emb.astype(np.float32)
        i = int(np.argmax(sims))
        return self._ids[i], float(sims[i])

    def __len__(self):
        return len(self._embs)


class ReusableMCTS:
    """Shares MCTS statistics across queries through embedding-matched
    states. ``embed_fn(plan, catalog) -> np.ndarray`` is Query2Vec
    (``core.optimizer.QueryEmbedder.embed``).

    Warm starts are two-layer: a query whose root embedding collides with a
    well-visited stored node gets the reduced ``warm_iterations`` budget,
    and its first iteration *replays* the stored node's best known rule
    chain (``_RNode.best_seq``) — each rule re-configured for the concrete
    query by ``configure_action``, inapplicable steps skipped — before the
    remaining iterations search normally. The serving tier primes exactly
    this structure from live traffic (``repro_torch.serving.feedback``): one
    full optimization per hot signature deposits its best chain in the
    ``NodeIndex``-matched root, so the next same-family query reaches a
    comparable plan in a fraction of the iterations."""

    def __init__(self, catalog_fn, embed_fn, cost_fn_factory,
                 iterations: int = 40, warm_iterations: int = 10,
                 c: float = 0.7, max_depth: int = 6, sim_threshold: float = 0.9995,
                 seed: int = 0, actions: Optional[List[str]] = None):
        self.embed_fn = embed_fn
        self.cost_fn_factory = cost_fn_factory
        self.iterations = iterations
        self.warm_iterations = warm_iterations
        self.c = c
        self.max_depth = max_depth
        self.sim_threshold = sim_threshold
        self.rng = random.Random(seed)
        self.actions = actions or ACTION_SPACE
        self.nodes: List[_RNode] = []
        self.index = NodeIndex()
        self.queries = 0
        self.collisions = 0

    # -- node store -------------------------------------------------------
    def _get_or_create(self, emb: np.ndarray) -> Tuple[_RNode, bool]:
        nid, sim = self.index.search(emb)
        if nid >= 0 and sim >= self.sim_threshold:
            return self.nodes[nid], True
        node = _RNode(nid=len(self.nodes), embed=emb)
        self.nodes.append(node)
        self.index.add(node.nid, emb)
        return node, False

    def storage_bytes(self) -> int:
        return sum(n.storage_bytes() for n in self.nodes)

    # -- search (Alg. 5) ----------------------------------------------------
    def optimize(self, plan: ir.Plan, catalog: ir.Catalog) -> Tuple[ir.Plan, Dict]:
        cost_fn = self.cost_fn_factory(catalog)
        emb0 = self.embed_fn(plan, catalog)
        root, hit = self._get_or_create(emb0)
        self.queries += 1
        if hit:
            self.collisions += 1
        warm = hit and root.n > 0
        iters = self.warm_iterations if warm else self.iterations
        root_cost = cost_fn(plan)
        best_plan, best_cost = plan, root_cost
        best_seq: Tuple[str, ...] = ()
        replayed = False

        for it in range(iters):
            # warm start, layer 2: the first warm iteration replays the
            # matched root's best known rule chain, re-configured for this
            # concrete query (skipping inapplicable steps). Embedding
            # collapse can poison child/dead bookkeeping across queries,
            # so the sketch — not the UCB statistics — is what reliably
            # transfers a good plan to a structural sibling.
            replay = (list(root.best_seq)
                      if (warm and it == 0 and root.best_seq) else None)
            node = root
            cur_plan, cur_cost = plan, root_cost
            depth = 0
            path = [node]
            applied: list = []
            while depth < self.max_depth:
                if node.untried is None:
                    node.untried = [a for a in self.actions if a not in node.dead]
                if replay is not None:
                    if not replay:
                        break
                    a = replay.pop(0)
                else:
                    # well-visited nodes (warm-started from a previous
                    # query's search) exploit their known-good children
                    # first; fresh nodes explore untried actions (standard
                    # MCTS expansion)
                    exploit = node.children and node.n >= 8
                    if node.untried and not exploit:
                        a = self.rng.choice(node.untried)
                        node.untried.remove(a)
                    else:
                        a = self._ucb(node)
                        if a is None:
                            if node.untried:
                                a = self.rng.choice(node.untried)
                                node.untried.remove(a)
                            else:
                                break
                res = configure_action(cur_plan, catalog, a, cost_fn)
                if res is None:
                    if replay is None:
                        # replayed steps don't mark shared state dead: the
                        # rule may be inapplicable only for *this* query
                        node.dead.add(a)
                        node.children.pop(a, None)
                    continue
                cur_plan, _ = res
                cur_cost = cost_fn(cur_plan)
                if replay is not None and node.untried and a in node.untried:
                    # an applied replay step counts as this node's expansion
                    # of that action — later iterations must not re-try it
                    node.untried.remove(a)
                emb = self.embed_fn(cur_plan, catalog)
                if a in node.children:
                    child = self.nodes[node.children[a]]
                else:
                    child, _ = self._get_or_create(emb)
                    node.children[a] = child.nid
                node = child
                path.append(node)
                depth += 1
                applied.append(a)
                if cur_cost < best_cost:
                    best_plan, best_cost = cur_plan, cur_cost
                    best_seq = tuple(applied)
            if replay is not None and applied:
                replayed = True  # at least one stored step actually applied
            reward = (root_cost - cur_cost) / max(root_cost, 1e-12)
            for nd in path:
                nd.n += 1
                nd.r += reward
        gain = root_cost / max(best_cost, 1e-12)
        if best_seq and gain > max(root.best_gain, 1.0 + 1e-3):
            root.best_seq, root.best_gain = best_seq, gain
        return best_plan, {"root_cost": root_cost, "best_cost": best_cost,
                           "speedup": gain, "collision": hit,
                           "iterations": iters, "replayed": replayed}

    def _ucb(self, node: _RNode) -> Optional[str]:
        best_a, best_v = None, -float("inf")
        for a, cid in node.children.items():
            ch = self.nodes[cid]
            v = ch.r / max(ch.n, 1) + self.c * math.sqrt(
                math.log(max(node.n, 1) + 1) / max(ch.n, 1))
            if v > best_v:
                best_a, best_v = a, v
        return best_a

    @property
    def collision_rate(self) -> float:
        return self.collisions / max(self.queries, 1)
