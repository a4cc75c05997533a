"""The port's learned embeddings against the JAX package's, on the CPU.

Host featurization is held exactly: ``featurize_graph`` on the graphs of
``builders.sample_model(0..39)`` and of every function of the 12 workloads,
every ``PlanFeatures`` field on the 12 workloads (scale 0.3) as built and
after ``kernel_plan`` (whose BlockedMatmul slots carry the +0.5 backend
bit, ``kernel`` here and ``pallas`` there) and on 20 template queries, the
WL Counters of graphs and plans, and ``mine_triples``.

The networks are held under the JAX package's weights carried over by
``convert.embedder_from_numpy`` (every leaf perturbed by a seeded N(0,
0.05), so that biases and norm gains are not at their initial values):
``Model2Vec``, ``Query2Vec`` and ``LatencyHead`` equal
``model2vec_apply``, ``query2vec_apply`` and ``latency_apply`` at
rtol=atol=FWD_TOL (float32), fully masked rows and plan slots included; one
training step's loss and every gradient leaf, for Task-1 over graphs,
Task-1 over plans and Task-2, at rtol=GRAD_TOL (atol GRAD_TOL times the
leaf's largest |gradient|: an entry near 0 is a difference of sums).
``train.optim.AdamW`` equals the reference's update at ADAMW_TOL, the clip
active and not, with weight decay and with bfloat16 moments. The
properties of ``tests/test_embedding.py`` hold on the port's own weights.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding as JE, optimizer as jom, wl as jwlk
from repro.core.plan_cache import LRUCache as JLRUCache
from repro.core.planner import analytic_cost_fn as j_cost_fn
from repro.data import templates as jtemplates, workloads as jworkloads
from repro.mlfuncs import builders as jbuilders
from repro.train.optim import AdamW as JAdamW
from repro_torch import convert
from repro_torch.core import embedding as E, ir, optimizer as om, wl
from repro_torch.core.plan_cache import LRUCache
from repro_torch.core.planner import analytic_cost_fn
from repro_torch.core.rules import kernel_plan
from repro_torch.data import templates, workloads as tworkloads
from repro_torch.mlfuncs import builders
from repro_torch.train.optim import AdamW

from test_torch_lowering import _jax_kernel_plan
from test_torch_search import one_torch_thread  # noqa: F401

FWD_TOL = 1e-5     # float32 forwards, the same weights
GRAD_TOL = 1e-4    # one step's loss and gradients
ADAMW_TOL = 1e-6   # one optimizer update
SCALE = 0.3
NAMES = sorted(jworkloads.ALL_WORKLOADS)
TEMPLATE_QUERIES = [(t, 50 + t) for t in sorted(jtemplates.TEMPLATES)]


@functools.lru_cache(maxsize=None)
def _workload(name):
    jw = jworkloads.ALL_WORKLOADS[name](scale=SCALE)
    tw = tworkloads.ALL_WORKLOADS[name](scale=SCALE, device="cpu")
    return jw, tw


@functools.lru_cache(maxsize=None)
def _template(t, seed):
    return (jtemplates.sample_query(t, seed=seed, scale=SCALE),
            templates.sample_query(t, seed=seed, scale=SCALE, device="cpu"))


def _graphs(n=40):
    pairs = [(jbuilders.sample_model(s).graph, builders.sample_model(s).graph)
             for s in range(n)]
    return [(j, t) for j, t in pairs if j is not None]


def _features_equal(jpf, tpf, label):
    for field in E.PlanFeatures.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(tpf, field), getattr(jpf, field),
                                      err_msg=f"{label}: {field}")


def _jax_trees(jemb, noise_seed=None):
    """The JAX embedder's param trees as numpy, each leaf plus a seeded
    N(0, 0.05) when ``noise_seed`` is given."""
    rng = np.random.default_rng(noise_seed)
    tree = {p: jax.tree.map(np.asarray, getattr(jemb, p)) for p in convert.EMBEDDER_PARTS}
    if noise_seed is not None:
        tree = jax.tree.map(
            lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree)
    return dict(tree, one_model=jemb.one_model)


@functools.lru_cache(maxsize=None)
def _twins(seed=0, noise_seed=7):
    """A JAX embedder and the port's carrying the same weights."""
    jemb = jom.init_embedder(seed)
    tree = _jax_trees(jemb, noise_seed)
    for p in convert.EMBEDDER_PARTS:
        setattr(jemb, p, jax.tree.map(jnp.asarray, tree[p]))
    return jemb, convert.embedder_from_numpy(tree, device="cpu")


def _close(got, want, tol, label=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=label)


# ---------------------------------------------------------------------------
# host featurization and WL: exact
# ---------------------------------------------------------------------------

def test_featurize_graph_and_graph_wl_match_jax_on_sampled_models():
    pairs = _graphs()
    assert len(pairs) > 20
    for i, (jg, tg) in enumerate(pairs):
        for want, got in zip(JE.featurize_graph(jg), E.featurize_graph(tg)):
            np.testing.assert_array_equal(got, want, err_msg=f"sample_model {i}")
        assert wl.graph_wl(tg) == jwlk.graph_wl(jg)
    assert [a.tolist() for a in E.featurize_graph(None)] == \
        [a.tolist() for a in JE.featurize_graph(None)]


@pytest.mark.parametrize("name", NAMES)
def test_plan_features_match_jax_on_workloads(name):
    """Every field, as built and after ``kernel_plan``; the functions'
    graph features and WL Counters; the plans' WL Counters."""
    jw, tw = _workload(name)
    for fn in jw.plan.registry:
        jg, tg = jw.plan.registry.get(fn).graph, tw.plan.registry.get(fn).graph
        for want, got in zip(JE.featurize_graph(jg), E.featurize_graph(tg)):
            np.testing.assert_array_equal(got, want, err_msg=f"{name}/{fn}")
        if jg is not None:
            assert wl.graph_wl(tg) == jwlk.graph_wl(jg), f"{name}/{fn}"
    for label, jplan, tplan in (
            ("plan", jw.plan, tw.plan),
            ("kernel_plan", _jax_kernel_plan(jw.plan, jw.catalog),
             kernel_plan(tw.plan, tw.catalog))):
        _features_equal(JE.featurize_plan(jplan, jw.catalog),
                        E.featurize_plan(tplan, tw.catalog), f"{name}/{label}")
        assert (wl.plan_wl(tplan.root, tplan.registry, phys=tplan.phys)
                == jwlk.plan_wl(jplan.root, jplan.registry, phys=jplan.phys))


def test_kernel_plan_sets_the_backend_bit():
    """rec_q3's kernel plan runs its BlockedMatmul on the kernel: its slot
    carries n_tiles / 16 + 0.5, which a plain copy of the reference's
    ``== "pallas"`` test would drop."""
    _, tw = _workload("rec_q3")
    kplan = kernel_plan(tw.plan, tw.catalog)
    pf = E.featurize_plan(kplan, tw.catalog)
    slots = np.flatnonzero(pf.op_ids == E._REL_OPS.index("blockedmm"))
    assert len(slots) > 0
    tiles = [kplan.phys_for(n).n_tiles for n in ir.walk(kplan.root)
             if isinstance(n, ir.BlockedMatmul)]
    np.testing.assert_allclose(sorted(pf.pred_vals[slots]),
                               sorted(t / 16.0 + 0.5 for t in tiles), rtol=0, atol=1e-7)


@pytest.mark.parametrize("t,seed", TEMPLATE_QUERIES)
def test_plan_features_match_jax_on_templates(t, seed):
    (jplan, jcat), (tplan, tcat) = _template(t, seed)
    _features_equal(JE.featurize_plan(jplan, jcat), E.featurize_plan(tplan, tcat),
                    f"template {t}")
    assert (wl.plan_wl(tplan.root, tplan.registry, phys=tplan.phys)
            == jwlk.plan_wl(jplan.root, jplan.registry, phys=jplan.phys))


def test_mine_triples_match_jax():
    pairs = _graphs()
    jf = [jwlk.graph_wl(j) for j, _ in pairs]
    tf = [wl.graph_wl(t) for _, t in pairs]
    assert om.mine_triples(pairs, tf, 300, seed=3) == jom.mine_triples(pairs, jf, 300, seed=3)
    plans = [_template(t, s) for t, s in TEMPLATE_QUERIES]
    jf = [jwlk.plan_wl(j.root, j.registry, phys=j.phys) for (j, _), _ in plans]
    tf = [wl.plan_wl(p.root, p.registry, phys=p.phys) for _, (p, _) in plans]
    assert om.mine_triples(plans, tf, 256) == jom.mine_triples(plans, jf, 256)


# ---------------------------------------------------------------------------
# forwards under the same weights
# ---------------------------------------------------------------------------

def _graph_batch(n=12):
    enc = [JE.featurize_graph(j) for j, _ in _graphs(n)]
    feats = np.stack([f for f, _ in enc] + [np.zeros_like(enc[0][0])])
    masks = np.stack([m for _, m in enc] + [np.zeros_like(enc[0][1])])  # all masked
    return feats, masks


def _plan_batch(queries=TEMPLATE_QUERIES[:8]):
    pfs = [JE.featurize_plan(*_template(t, s)[0]) for t, s in queries]
    return tuple(np.stack(a) for a in zip(*(JE.pf_to_arrays(pf) for pf in pfs)))


def test_model2vec_matches_jax_with_masked_rows():
    jemb, temb = _twins()
    feats, masks = _graph_batch()
    want = jax.vmap(lambda f, m: JE.model2vec_apply(jemb.m2v, f, m))(feats, masks)
    got = temb.m2v(torch.from_numpy(feats), torch.from_numpy(masks))
    assert not masks[-1].any() and got.shape == (len(feats), E.EXPR_DIM)
    assert torch.isfinite(got).all()
    _close(got, want, FWD_TOL, "model2vec")
    _close(temb.embed_expr(_graphs(1)[0][1]), jemb.embed_expr(_graphs(1)[0][0]), FWD_TOL)


def test_query2vec_and_latency_match_jax():
    jemb, temb = _twins()
    arrays = _plan_batch()
    assert not arrays[-1].all()  # plan slots past each plan are masked
    want = jax.vmap(lambda *xs: JE.query2vec_apply(jemb.q2v, jemb.m2v, xs))(*arrays)
    tarr = tuple(torch.from_numpy(a) for a in arrays)
    got = temb.forward("embed", tarr)
    assert got.shape == (len(arrays[0]), E.NODE_DIM)
    _close(got, want, FWD_TOL, "query2vec")
    _close(temb.forward("latency", tarr), JE.latency_apply(
        jemb.latency_head, jax.vmap(lambda *xs: JE.query2vec_apply(
            jemb.latency_q2v, jemb.m2v, xs))(*arrays)), FWD_TOL, "latency")
    (jp, jc), (tp, tc) = _template(4, 54)
    _close(temb.embed(tp, tc), jemb.embed(jp, jc), FWD_TOL, "embed")
    assert temb.predict_latency(tp, tc) == pytest.approx(jemb.predict_latency(jp, jc),
                                                         rel=FWD_TOL)


def test_fully_masked_plan_is_finite_with_finite_gradients():
    """Every slot masked: the reference's uniform softmax over -1e30, no NaN
    in the output or in any gradient."""
    jemb, temb = _twins()
    arrays = [np.zeros_like(a[:1]) for a in _plan_batch(TEMPLATE_QUERIES[:1])]
    tarr = tuple(torch.from_numpy(a) for a in arrays)
    params = {k: v.detach().clone().requires_grad_() for k, v in temb.q2v.named_parameters()}
    out = torch.func.functional_call(temb.q2v, params,
                                     (E.expr_embeddings(temb.m2v, tarr), tarr))
    grads = torch.autograd.grad(out.sum(), list(params.values()))
    assert all(torch.isfinite(g).all() for g in grads) and torch.isfinite(out).all()
    _close(out, JE.query2vec_apply(jemb.q2v, jemb.m2v, tuple(a[0] for a in arrays))[None],
           FWD_TOL, "all masked")


# ---------------------------------------------------------------------------
# one training step: loss and gradients
# ---------------------------------------------------------------------------

def _grad_close(tgrads: dict, jgrads, label):
    flat = convert._flat(jax.tree.map(np.asarray, jgrads))
    assert set(flat) == set(tgrads), label
    for k, want in flat.items():
        atol = GRAD_TOL * float(np.abs(want).max())
        np.testing.assert_allclose(tgrads[k].numpy(), want, rtol=GRAD_TOL, atol=atol,
                                   err_msg=f"{label}: {k}")


def _with_grad(params: dict) -> dict:
    return {k: v.detach().clone().requires_grad_() for k, v in params.items()}


def _port_grads(loss, params: dict) -> dict:
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def _triples(rng, n, b=6):
    return tuple(rng.integers(0, n, b) for _ in range(3))


def test_model2vec_step_matches_jax():
    jemb, temb = _twins()
    feats, masks = _graph_batch(24)
    a, p, n = _triples(np.random.default_rng(1), len(feats))

    def jloss(prm):
        e = lambda i: jax.vmap(lambda f, m: JE.model2vec_apply(prm, f, m))(feats[i], masks[i])
        return JE.contrastive_loss(e(a), e(p), e(n))
    jl, jg = jax.value_and_grad(jloss)(jemb.m2v)
    params = _with_grad(dict(temb.m2v.named_parameters()))
    tl = om.model2vec_loss(temb.m2v, params, torch.from_numpy(feats), torch.from_numpy(masks),
                           *(torch.from_numpy(x) for x in (a, p, n)))
    _close(tl, jl, GRAD_TOL, "loss")
    _grad_close(_port_grads(tl, params), jg, "m2v")


def test_query2vec_step_matches_jax():
    jemb, temb = _twins()
    arrays = _plan_batch(TEMPLATE_QUERIES)
    a, p, n = _triples(np.random.default_rng(2), len(arrays[0]), 4)

    def jloss(prm):
        def e(i):
            sel = tuple(x[i] for x in arrays)
            return jax.vmap(lambda *xs: JE.query2vec_apply(prm, jemb.m2v, xs))(*sel)
        return JE.contrastive_loss(e(a), e(p), e(n))
    jl, jg = jax.value_and_grad(jloss)(jemb.q2v)
    params = _with_grad(dict(temb.q2v.named_parameters()))
    tarr = tuple(map(torch.from_numpy, arrays))
    tl = om.query2vec_loss(temb.q2v, params, E.expr_embeddings(temb.m2v, tarr), tarr,
                           *(torch.from_numpy(x) for x in (a, p, n)))
    _close(tl, jl, GRAD_TOL, "loss")
    _grad_close(_port_grads(tl, params), jg, "q2v")


def test_latency_step_matches_jax():
    jemb, temb = _twins()
    arrays = _plan_batch(TEMPLATE_QUERIES)
    y = np.log(np.random.default_rng(3).uniform(1e-4, 1e-1, len(arrays[0])) + 1e-9
               ).astype(np.float32)
    idx = np.random.default_rng(4).integers(0, len(y), 8)

    def jloss(prm):
        sel = tuple(x[idx] for x in arrays)
        emb = jax.vmap(lambda *xs: JE.query2vec_apply(prm["q2v"], jemb.m2v, xs))(*sel)
        return JE.latency_loss(JE.latency_apply(prm["head"], emb), y[idx])
    jl, jg = jax.value_and_grad(jloss)({"q2v": jemb.latency_q2v, "head": jemb.latency_head})
    params = {"q2v": _with_grad(dict(temb.latency_q2v.named_parameters())),
              "head": _with_grad(dict(temb.latency_head.named_parameters()))}
    tarr = tuple(map(torch.from_numpy, arrays))
    tl = om.latency_task_loss(temb.latency_q2v, temb.latency_head, params,
                              E.expr_embeddings(temb.m2v, tarr), tarr, torch.from_numpy(y),
                              torch.from_numpy(idx))
    _close(tl, jl, GRAD_TOL, "loss")
    flat = {f"{part}.{k}": v for part in params for k, v in params[part].items()}
    _grad_close(_port_grads(tl, flat), jg, "latency")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,gscale", [
    (dict(grad_clip=1.0), 10.0),                  # clip active
    (dict(grad_clip=1.0), 1e-3),                  # clip inactive
    (dict(grad_clip=None, weight_decay=0.1), 1.0),
    (dict(moment_dtype="bfloat16", weight_decay=0.01), 3.0),
])
def test_adamw_update_matches_jax(kw, gscale):
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "blocks": [{"w": (5, 3)}, {"w": (3,)}], "b": ()}
    draw = lambda s, k=1.0: np.asarray(k * rng.standard_normal(s), np.float32)
    params = jax.tree.map(draw, shapes, is_leaf=lambda x: isinstance(x, tuple))
    jopt, topt = JAdamW(lr=1e-2, **kw), AdamW(lr=1e-2, **kw)
    jp, js = params, jopt.init(params)
    tp = jax.tree.map(torch.from_numpy, params)
    ts = topt.init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda a: draw(a.shape, gscale), params)
        jp, js = jopt.update(g, js, jp)
        tp, ts = topt.update(jax.tree.map(torch.from_numpy, g), ts, tp)
    assert int(ts.step) == int(js.step) == 3
    for want, got in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
        for w, t in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert t.dtype == (torch.bfloat16 if str(w.dtype) == "bfloat16" else torch.float32)
            np.testing.assert_allclose(t.float().numpy(), np.asarray(w, np.float32),
                                       rtol=ADAMW_TOL, atol=ADAMW_TOL)


# ---------------------------------------------------------------------------
# tests/test_embedding.py's properties, on the port's own weights
# ---------------------------------------------------------------------------

def test_embedding_shapes_and_determinism():
    emb = om.init_embedder(0, device="cpu")
    plan, cat = templates.sample_query(2, seed=1, scale=SCALE, device="cpu")
    e1 = emb.embed(plan, cat)
    e2 = emb.embed(plan, cat)
    assert e1.shape == (393,) and e1.dtype == np.float32
    np.testing.assert_allclose(e1, e2)
    assert abs(np.linalg.norm(e1) - 1.0) < 1e-4
    assert (emb.cache_stats.hits, emb.cache_stats.misses) == (1, 1)
    twin = om.init_embedder(0, device="cpu")
    np.testing.assert_array_equal(twin.embed(plan, cat), e1)
    assert emb._cache.maxsize == om.EMBED_CACHE_SIZE == jom.EMBED_CACHE_SIZE


def test_embed_cache_counts_and_bound_match_jax():
    jemb, temb = _twins()
    jemb._cache, temb._cache = JLRUCache(3), LRUCache(3)
    order = [1, 2, 1, 3, 4, 1, 2, 5, 5]
    for t in order:
        (jp, jc), (tp, tc) = _template(t, 50 + t)
        _close(temb.embed(tp, tc), jemb.embed(jp, jc), FWD_TOL)
    assert temb.cache_stats.as_dict() == jemb.cache_stats.as_dict()
    assert len(temb._cache) == 3


def test_contrastive_training_separates():
    emb = om.init_embedder(0, device="cpu")
    graphs = [g for g in (builders.sample_model(s).graph for s in range(16)) if g is not None]
    r = om.train_model2vec(emb, graphs, steps=40, batch=8, lr=1e-4)
    assert np.isfinite(r["loss_last"])


def test_training_loops_start_from_jax_losses():
    """The same mined triples and batch indices: under the same weights each
    training function's first loss is the reference's."""
    jemb, _ = _twins()
    tree = _jax_trees(jemb)
    temb = convert.embedder_from_numpy(tree, device="cpu")
    jtwin = jom.init_embedder(0)
    for p in convert.EMBEDDER_PARTS:
        setattr(jtwin, p, jax.tree.map(jnp.asarray, tree[p]))
    pairs = _graphs(16)
    r_t = om.train_model2vec(temb, [t for _, t in pairs], steps=2, batch=4, lr=1e-4)
    r_j = jom.train_model2vec(jtwin, [j for j, _ in pairs], steps=2, batch=4, lr=1e-4)
    assert r_t["loss_first"] == pytest.approx(r_j["loss_first"], rel=GRAD_TOL)
    qs = [_template(t, s) for t, s in TEMPLATE_QUERIES[:10]]
    jplans, jcats = zip(*(q[0] for q in qs))
    tplans, tcats = zip(*(q[1] for q in qs))
    r_t = om.train_query2vec(temb, tplans, tcats, steps=2, batch=4)
    r_j = jom.train_query2vec(jtwin, jplans, jcats, steps=2, batch=4)
    assert r_t["loss_first"] == pytest.approx(r_j["loss_first"], rel=GRAD_TOL)
    costs = [j_cost_fn(c)(p) for p, c in zip(jplans, jcats)]
    r_t = om.train_latency(temb, tplans, tcats, costs, steps=2, batch=4)
    r_j = jom.train_latency(jtwin, jplans, jcats, costs, steps=2, batch=4)
    assert r_t["loss_first"] == pytest.approx(r_j["loss_first"], rel=GRAD_TOL)


def _costed_templates(ts, seeds, seed_of):
    plans, cats, costs = [], [], []
    for t in ts:
        for s in range(seeds):
            p, c = templates.sample_query(t, seed=seed_of(t, s), scale=SCALE, device="cpu")
            plans.append(p)
            cats.append(c)
            costs.append(analytic_cost_fn(c)(p))
    return plans, cats, costs


def test_latency_head_learns_ranking():
    emb = om.init_embedder(1, device="cpu")
    plans, cats, costs = _costed_templates((1, 5, 7, 11, 15, 16, 17, 18), 3,
                                           lambda t, s: 100 * t + s)
    om.train_query2vec(emb, plans, cats, steps=40, batch=8)
    om.train_latency(emb, plans, cats, costs, steps=150, batch=8)
    pred = np.array([emb.predict_latency(p, c) for p, c in zip(plans, cats)])
    corr = np.corrcoef(np.log(pred + 1e-12), np.log(np.array(costs)))[0, 1]
    assert corr > 0.5, f"latency head failed to learn ranking (corr={corr})"
    assert np.median(om.q_error(pred, np.array(costs))) >= 1.0


def test_two_model_vs_one_model_strategy():
    emb = om.init_embedder(2, device="cpu")
    plans, cats, costs = _costed_templates((1, 7, 16), 2, lambda t, s: 10 * t + s)
    q2v_before = {k: v.clone() for k, v in emb.q2v.state_dict().items()}
    r2 = om.train_latency(emb, plans, cats, costs, steps=50, one_model=False)
    assert not emb.one_model
    for k, v in emb.q2v.state_dict().items():  # two models: the shared one is untouched
        assert torch.equal(v, q2v_before[k])
    emb1 = om.init_embedder(3, device="cpu")
    r1 = om.train_latency(emb1, plans, cats, costs, steps=50, one_model=True)
    assert emb1.one_model
    assert np.isfinite(r1["loss_last"]) and np.isfinite(r2["loss_last"])
    p, c = plans[0], cats[0]
    with torch.no_grad():
        arrays = E.stack_features([E.featurize_plan(p, c)], "cpu")
        want = float(torch.exp(emb1.latency_head(E.query2vec_apply(emb1.q2v, emb1.m2v,
                                                                   arrays))[0]))
    assert emb1.predict_latency(p, c) == pytest.approx(want, rel=1e-6)


def test_training_drops_the_captured_forwards():
    """A captured forward replays the weights it saw: every training
    function drops them; only the latency and Query2Vec trainings clear the
    embedding cache, as the reference's do."""
    emb = om.init_embedder(4, device="cpu")
    plans, cats, costs = _costed_templates((1, 7), 2, lambda t, s: 10 * t + s)
    graphs = [g for g in (builders.sample_model(s).graph for s in range(8)) if g is not None]
    for train, clears in ((lambda: om.train_model2vec(emb, graphs, steps=1, batch=2), False),
                          (lambda: om.train_query2vec(emb, plans, cats, steps=1, batch=2), True),
                          (lambda: om.train_latency(emb, plans, cats, costs, steps=1, batch=2),
                           True)):
        emb.embed(plans[0], cats[0])
        emb._graphs["embed"] = object()  # stands in for a capture on the card
        train()
        assert emb._graphs == {} and (len(emb._cache) == 0) == clears
