"""Model2Vec + Query2Vec + latency head (paper Sec. IV-B), the port of
``repro.core.embedding``.

Model2Vec embeds a bottom-level IR (BFS node sequence; features E_mlType,
E_mlFlops, E_mlDims) with a small transformer into a 64-d expression vector
E_expr. Query2Vec builds one 393-d vector per top-level IR node per Eq. 1:
  E_o(64) ‖ E_j(64) ‖ E_t(64) ‖ E_p(64+8+1) ‖ E_h(64) ‖ E_s(64)  = 393
then runs a tree transformer with height encodings and mean-pools to the
final 393-d state embedding. The latency head is a 4-layer FFNN on it.

The host featurization (``featurize_graph``, ``featurize_plan``) is the
reference's numpy code; the one backend it reads is spelled ``kernel`` here
(``pallas`` there). The networks are ``nn.Module``s whose parameter names
are the reference's tree paths (``blocks.0.qkv.w``), linear weights
``[din, dout]`` applied as ``x @ w + b``, so ``convert.embedder_from_numpy``
carries a JAX embedder over leaf by leaf. They take a leading batch axis:
``Model2Vec`` maps ``[N, 64, 30]`` to ``[N, 64]``, ``expr_embeddings``
runs it over all ``B * 32`` plan slots in one call where the reference
vmaps, and ``Query2Vec`` maps those and the ``[B, 32, ...]`` plan features
to ``[B, 393]`` (``query2vec_apply`` composes the two). A fully masked row
(a plan slot past the plan, a node without an ML expression) softmaxes to
a uniform row over ``-1e30`` scores, as the reference's does: no ``-inf``,
no NaN in the forward or the gradients.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import ir
from repro_torch.mlfuncs.functions import MLGraph

# -- dimensions (paper Sec. IV-B2) ------------------------------------------
EXPR_DIM = 64
NODE_DIM = 393           # 5*64 + (64+8+1)
D_MODEL = 384            # transformer width (6 heads x 64)
MAX_GRAPH_NODES = 64
MAX_PLAN_NODES = 32
GRAPH_FEAT = 24 + 2 + 4  # type one-hot + [log flops, log dim] + dim histogram
N_KINDS = 24
_KINDS = ["matmul", "bias", "act", "concat", "cossim", "dot", "dist", "embed",
          "scale", "onehot", "forest", "fused_dense", "binarize", "slice",
          "add", "mul", "sqrt", "argmin", "const_vec", "opaque"]
_OPS = [">", "<", ">=", "<=", "==", "!=", "and", "or", "not", "isin"]


def _hash(s: str, mod: int) -> int:
    h = 2166136261
    for ch in s:
        h = ((h ^ ord(ch)) * 16777619) & 0xFFFFFFFF
    return h % mod


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls in full precision on the card inside it, whatever
    the caller set: the embeddings are held to the CPU at 1e-4."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# ===========================================================================
# tiny transformer
# ===========================================================================

class Linear(nn.Module):
    """``x @ w + b`` with ``w`` [din, dout] ~ N(0, 1) / sqrt(din), ``b`` 0."""

    def __init__(self, gen: torch.Generator, din: int, dout: int):
        super().__init__()
        self.w = nn.Parameter(torch.randn((din, dout), generator=gen) / np.sqrt(din))
        self.b = nn.Parameter(torch.zeros(dout))

    def forward(self, x):
        return x @ self.w + self.b


class LayerNorm(nn.Module):
    """The reference's: population variance, ``sqrt(var + 1e-6)``."""

    def __init__(self, d: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d))
        self.b = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        sd = torch.sqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-6)
        return (x - mu) / sd * self.g + self.b


class Block(nn.Module):
    def __init__(self, gen: torch.Generator, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(gen, d, 3 * d)
        self.o = Linear(gen, d, d)
        self.m1 = Linear(gen, d, 4 * d)
        self.m2 = Linear(gen, 4 * d, d)
        self.ln1 = LayerNorm(d)
        self.ln2 = LayerNorm(d)

    def forward(self, x, mask):
        # x: [N, n, d]; mask: [N, n] bool
        N, n, d = x.shape
        dh = d // self.heads
        qkv = self.qkv(self.ln1(x)).reshape(N, n, 3, self.heads, dh)
        q, k, v = qkv.unbind(2)
        s = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(dh)
        s = s.masked_fill(~mask[:, None, None, :], -1e30)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhnm,bmhd->bnhd", a, v).reshape(N, n, d)
        x = x + self.o(o)
        return x + self.m2(F.gelu(self.m1(self.ln2(x)), approximate="tanh"))


def _pool_out(out: Linear, x, mask):
    """Masked mean over the node axis, the output layer, unit norm."""
    m = mask[..., None].to(x.dtype)
    pooled = (x * m).sum(-2) / torch.clamp(m.sum(-2), min=1.0)
    y = out(pooled)
    return y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + 1e-8)


# ===========================================================================
# Model2Vec
# ===========================================================================

class Model2Vec(nn.Module):
    def __init__(self, gen: torch.Generator):
        super().__init__()
        self.add_module("in", Linear(gen, GRAPH_FEAT, EXPR_DIM))  # the reference's name
        self.blocks = nn.ModuleList([Block(gen, EXPR_DIM, 4), Block(gen, EXPR_DIM, 4)])
        self.out = Linear(gen, EXPR_DIM, EXPR_DIM)

    def forward(self, feats, mask):
        """feats [N, 64, 30], mask [N, 64] -> unit vectors [N, 64]."""
        x = self._modules["in"](feats)
        for blk in self.blocks:
            x = blk(x, mask)
        return _pool_out(self.out, x, mask)


def featurize_graph(g: Optional[MLGraph], in_dims: Optional[List[int]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """BFS node features: E_mlType (one-hot), E_mlFlops, E_mlDims."""
    feats = np.zeros((MAX_GRAPH_NODES, GRAPH_FEAT), np.float32)
    mask = np.zeros((MAX_GRAPH_NODES,), bool)
    if g is None:
        feats[0, N_KINDS - 1] = 1.0  # opaque marker
        mask[0] = True
        return feats, mask
    in_dims = in_dims or [64] * g.n_inputs
    dims = g.infer_dims(in_dims)
    # BFS from output (paper: breadth-first traversal)
    order, frontier, seen = [], [g.out], set()
    by_id = {n.id: n for n in g.nodes}
    while frontier:
        nxt = []
        for nid in frontier:
            if nid in seen:
                continue
            seen.add(nid)
            order.append(nid)
            for r in by_id[nid].args:
                if r[0] == "node":
                    nxt.append(r[1])
        frontier = nxt
    for i, nid in enumerate(order[:MAX_GRAPH_NODES]):
        n = by_id[nid]
        arg_dims = [in_dims[r[1]] if r[0] == "in" else dims[r[1]] for r in n.args]
        kidx = _KINDS.index(n.atom.kind) if n.atom.kind in _KINDS else N_KINDS - 1
        feats[i, kidx] = 1.0
        fl = max(n.atom.flops_per_row(arg_dims), 1.0)
        feats[i, N_KINDS] = np.log1p(fl) / 10.0
        feats[i, N_KINDS + 1] = np.log1p(max(dims[nid], 1)) / 10.0
        d = max(dims[nid], 1)
        feats[i, N_KINDS + 2 + min(3, int(np.log2(d) // 3))] = 1.0
        mask[i] = True
    return feats, mask


# ===========================================================================
# Query2Vec
# ===========================================================================

class Query2Vec(nn.Module):
    def __init__(self, gen: torch.Generator):
        super().__init__()
        emb = lambda *shape, s: nn.Parameter(torch.randn(shape, generator=gen) * s)
        self.op_embed = emb(12, 64, s=0.1)                  # E_o
        self.join_embed = emb(4, 64, s=0.1)                 # E_j
        self.table_embed = emb(64, 64, s=0.1)               # E_t
        self.col_embed = emb(64, 64, s=0.1)                 # E_p filter
        self.expr_proj = Linear(gen, EXPR_DIM, 64)          # E_expr -> filter slot
        self.pred_op = emb(11, 8, s=0.1)                    # E_p op
        self.hist = Linear(gen, 8, 64)                      # E_h
        self.sample = Linear(gen, 64, 64)                   # E_s
        self.add_module("in", Linear(gen, NODE_DIM, D_MODEL))  # the reference's name
        self.height = emb(16, D_MODEL, s=0.02)
        self.blocks = nn.ModuleList([Block(gen, D_MODEL, 6), Block(gen, D_MODEL, 6)])
        self.out = Linear(gen, D_MODEL, NODE_DIM)

    def forward(self, e_expr, arrays):
        """``e_expr``: ``expr_embeddings`` of the plans [B, P, 64];
        ``arrays``: ``pf_to_arrays`` of B plans stacked, each [B, P, ...]
        -> unit vectors [B, 393]."""
        (op_ids, join_ids, table_ids, col_ids, has_expr, _, _,
         pred_ops, pred_vals, hists, samples, heights, mask) = arrays
        e_o = self.op_embed[op_ids.long()]                  # [B, P, 64]
        e_j = self.join_embed[join_ids.long()]
        e_t = self.table_embed[table_ids.long()]
        filt = torch.where(has_expr[..., None] > 0, self.expr_proj(e_expr),
                           self.col_embed[col_ids.long()])
        e_p = torch.cat([filt, self.pred_op[pred_ops.long()], pred_vals[..., None]], -1)
        node = torch.cat([e_o, e_j, e_t, e_p, self.hist(hists), self.sample(samples)], -1)
        x = self._modules["in"](node) + self.height[heights.long()]
        for blk in self.blocks:
            x = blk(x, mask)
        return _pool_out(self.out, x, mask)


def expr_embeddings(m2v: Model2Vec, arrays):
    """Model2Vec over every plan slot's expression graph, the B * P slots in
    one call: [B, P, 64]. Query2Vec reads it only where ``has_expr``, and
    Model2Vec is fixed while Query2Vec trains, so training computes it once."""
    expr_feats, expr_masks = arrays[5], arrays[6]
    B, P = expr_masks.shape[:2]
    return m2v(expr_feats.reshape(B * P, MAX_GRAPH_NODES, GRAPH_FEAT),
               expr_masks.reshape(B * P, MAX_GRAPH_NODES)).reshape(B, P, EXPR_DIM)


def query2vec_apply(q2v: Query2Vec, m2v: Model2Vec, arrays):
    """The reference's ``query2vec_apply`` over B stacked plans: [B, 393]."""
    return q2v(expr_embeddings(m2v, arrays), arrays)


_REL_OPS = ["scan", "filter", "project", "join", "crossjoin", "aggregate",
            "compact", "blockedmm", "forestrel", "union", "other"]


@dataclasses.dataclass
class PlanFeatures:
    """Host-side featurization of one plan (numpy)."""
    op_ids: np.ndarray       # [P] int
    join_ids: np.ndarray     # [P] int
    table_ids: np.ndarray    # [P] int
    col_ids: np.ndarray      # [P] int
    has_expr: np.ndarray     # [P] float (1 -> use E_expr in the filter slot)
    expr_feats: np.ndarray   # [P, MAX_GRAPH_NODES, GRAPH_FEAT]
    expr_masks: np.ndarray   # [P, MAX_GRAPH_NODES]
    pred_ops: np.ndarray     # [P] int
    pred_vals: np.ndarray    # [P] float
    hists: np.ndarray        # [P, 8]
    samples: np.ndarray      # [P, 64]
    heights: np.ndarray      # [P] int
    mask: np.ndarray         # [P] bool


def featurize_plan(plan: ir.Plan, catalog: ir.Catalog) -> PlanFeatures:
    P = MAX_PLAN_NODES
    f = PlanFeatures(
        op_ids=np.zeros(P, np.int32), join_ids=np.zeros(P, np.int32),
        table_ids=np.zeros(P, np.int32), col_ids=np.zeros(P, np.int32),
        has_expr=np.zeros(P, np.float32),
        expr_feats=np.zeros((P, MAX_GRAPH_NODES, GRAPH_FEAT), np.float32),
        expr_masks=np.zeros((P, MAX_GRAPH_NODES), bool),
        pred_ops=np.zeros(P, np.int32), pred_vals=np.zeros(P, np.float32),
        hists=np.zeros((P, 8), np.float32), samples=np.zeros((P, 64), np.float32),
        heights=np.zeros(P, np.int32), mask=np.zeros(P, bool))
    i = [0]

    def first_call(e: ir.Expr):
        if isinstance(e, ir.Call):
            return e
        for c in e.children():
            r = first_call(c)
            if r is not None:
                return r
        return None

    def visit(n: ir.RelNode, height: int):
        # in-order: left subtree, node, right subtree (paper Sec. IV-B1)
        kids = n.children()
        if kids:
            visit(kids[0], height + 1)
        k = i[0]
        if k < P:
            if isinstance(n, ir.Scan):
                op = "scan"
                f.table_ids[k] = _hash(n.table, 64)
                st = catalog.stats.get(n.table)
                if st is not None and st.sample_bitmap is not None:
                    f.samples[k] = st.sample_bitmap
            elif isinstance(n, ir.Filter):
                op = "filter"
                _pred_features(f, k, n.pred, plan.registry, catalog)
            elif isinstance(n, ir.Project):
                op = "project"
                calls = [c for _, e in n.outputs for c in [first_call(e)] if c]
                if calls:
                    _call_features(f, k, calls[0], plan.registry)
            elif isinstance(n, ir.Join):
                op = "join"
                f.join_ids[k] = 1
                f.col_ids[k] = _hash(n.left_key, 64)
            elif isinstance(n, ir.CrossJoin):
                op = "crossjoin"
                f.join_ids[k] = 2
            elif isinstance(n, ir.Aggregate):
                op = "aggregate"
                f.col_ids[k] = _hash(n.key, 64)
            elif isinstance(n, ir.Compact):
                op = "compact"
                f.pred_vals[k] = np.log1p(n.capacity) / 20.0
            elif isinstance(n, ir.BlockedMatmul):
                op = "blockedmm"
                fn = plan.registry.get(n.fn)
                ef, em = featurize_graph(fn.graph)
                f.expr_feats[k], f.expr_masks[k] = ef, em
                f.has_expr[k] = 1.0
                pc = plan.phys_for(n)
                f.pred_vals[k] = pc.n_tiles / 16.0 + (0.5 if pc.backend == "kernel" else 0.0)
            elif isinstance(n, ir.ForestRelational):
                op = "forestrel"
                fn = plan.registry.get(n.fn)
                ef, em = featurize_graph(fn.graph)
                f.expr_feats[k], f.expr_masks[k] = ef, em
                f.has_expr[k] = 1.0
            else:
                op = "other"
            f.op_ids[k] = _REL_OPS.index(op)
            f.heights[k] = min(height, 15)
            f.mask[k] = True
        i[0] += 1
        for c in kids[1:]:
            visit(c, height + 1)

    def _pred_features(f, k, pred, registry, catalog):
        if isinstance(pred, ir.BoolOp) and pred.args:
            pred_inner = pred.args[0]
        else:
            pred_inner = pred
        if isinstance(pred_inner, ir.Cmp):
            f.pred_ops[k] = _OPS.index(pred_inner.op)
            if isinstance(pred_inner.b, ir.Const):
                f.pred_vals[k] = np.tanh(pred_inner.b.value / 100.0)
            c = first_call(pred_inner)
            if c is not None:
                _call_features(f, k, c, registry)
            elif isinstance(pred_inner.a, ir.Col):
                f.col_ids[k] = _hash(pred_inner.a.name, 64)
                for st in catalog.stats.values():
                    cs = st.columns.get(pred_inner.a.name)
                    if cs is not None and cs.histogram is not None:
                        f.hists[k] = cs.histogram
                        break
        elif isinstance(pred_inner, ir.IsIn):
            f.pred_ops[k] = _OPS.index("isin")
            f.pred_vals[k] = len(pred_inner.values) / 16.0
            if isinstance(pred_inner.a, ir.Col):
                f.col_ids[k] = _hash(pred_inner.a.name, 64)

    def _call_features(f, k, call: ir.Call, registry):
        fn = registry.get(call.fn)
        ef, em = featurize_graph(fn.graph)
        f.expr_feats[k], f.expr_masks[k] = ef, em
        f.has_expr[k] = 1.0

    visit(plan.root, 0)
    return f


def pf_to_arrays(pf: PlanFeatures):
    return (pf.op_ids, pf.join_ids, pf.table_ids, pf.col_ids, pf.has_expr,
            pf.expr_feats, pf.expr_masks, pf.pred_ops, pf.pred_vals, pf.hists,
            pf.samples, pf.heights, pf.mask)


def stack_features(pfs: Sequence[PlanFeatures], device) -> tuple:
    """``pf_to_arrays`` of several plans as tensors [B, P, ...] on ``device``."""
    return tuple(torch.from_numpy(np.stack(a)).to(device)
                 for a in zip(*(pf_to_arrays(pf) for pf in pfs)))


# ===========================================================================
# latency head (Task 2: 4-layer FFNN on the query embedding)
# ===========================================================================

class LatencyHead(nn.Module):
    def __init__(self, gen: torch.Generator):
        super().__init__()
        self.l1 = Linear(gen, NODE_DIM, 256)
        self.l2 = Linear(gen, 256, 128)
        self.l3 = Linear(gen, 128, 64)
        self.l4 = Linear(gen, 64, 1)

    def forward(self, emb):
        """Predicted log latency, [...] from embeddings [..., 393]."""
        h = torch.relu(self.l1(emb))
        h = torch.relu(self.l2(h))
        h = torch.relu(self.l3(h))
        return self.l4(h)[..., 0]


# ===========================================================================
# losses (Eq. 2-4)
# ===========================================================================

def contrastive_loss(anchor, pos, neg, tau: float = 0.2):
    """Eq. 3: -log exp(sim+ / tau) / (exp(sim- / tau) + exp(sim+ / tau))."""
    sp = torch.sum(anchor * pos, -1) / tau
    sn = torch.sum(anchor * neg, -1) / tau
    return torch.mean(-(sp - torch.logaddexp(sp, sn)))


def latency_loss(pred_log, true_log):
    return torch.mean((pred_log - true_log) ** 2)
