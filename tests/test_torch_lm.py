"""The port's dense-GQA LM path against the JAX package, on the CPU.

Params come from the JAX package's ``init_params`` and cross with
``convert.lm_params_from_numpy``; tokens come from a numpy seed. The
port's ``forward``, ``prefill`` and ``decode_step`` (whose attention runs
the kernels' plain versions on CPU tensors) are held against
``repro.models.lm`` for the smoke configs of the four dense-GQA archs at
2e-4 in float32, and for granite in bfloat16 at 3e-2 (the kernels'
bfloat16 bar; one bf16 ulp is 3.9e-3 relative, and an ulp flip in one
layer's norm or residual carries through the next). The ``Server`` and the
Appendix K query are held against their JAX counterparts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke
from repro.core import ir as jir
from repro.core.executor import execute as j_execute
from repro.core.planner import analytic_cost_fn as j_cost_fn
from repro.core.planner import optimize_vanilla_mcts as j_vanilla_mcts
from repro.launch import serve as jserve
from repro.mlfuncs import builders as jbuilders
from repro.mlfuncs.functions import MLFunction as JMLFunction
from repro.mlfuncs.registry import Registry as JRegistry
from repro.models import layers as jL, lm as jlm
from repro.relational.table import Table as JTable
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.executor import execute
from repro_torch.launch import serve
from repro_torch.launch.serve_llm_udf import llm_udf_query, naive_and_optimized
from repro_torch.models import layers as tL, lm
from repro_torch.testing import assert_canonical_close

from test_torch_rules import port_signature, sync_fresh_names

DENSE_GQA = ("granite-3-2b", "stablelm-12b", "deepseek-67b", "nemotron-4-15b")
F32_TOL, BF16_TOL = 2e-4, 3e-2
CONSISTENCY_TOL = 1e-2  # tests/test_archs.py::test_smoke_decode_consistency


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(j_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw))


def _params(jcfg, seed=0):
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return pj, convert.lm_params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs, params, layers
# ---------------------------------------------------------------------------

def test_configs_are_copies():
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for arch in ARCHS:
        for mine, ref in ((get_config(arch), j_get_config(arch)),
                          (get_smoke_config(arch), j_smoke(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
            assert (mine.hd, mine.padded_vocab, mine.param_count()) == \
                (ref.hd, ref.padded_vocab, ref.param_count())


def test_param_shapes_and_init_match_jax():
    cfg = get_smoke_config("granite-3-2b")
    pj = jlm.init_params(j_smoke("granite-3-2b"), jax.random.PRNGKey(0))
    pt = lm.init_params(cfg, seed=0, device="cpu")
    flat_j = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(pj)}
    flat_t = {f"['blocks']['{k}']": v for k, v in pt["blocks"].items()}
    flat_t.update({"['embed']": pt["embed"], "['final_norm']": pt["final_norm"]})
    assert set(flat_j) == set(flat_t)
    for k, v in flat_j.items():
        assert tuple(v.shape) == tuple(flat_t[k].shape) and flat_t[k].dtype == torch.bfloat16
    for name in ("ln1", "ln2"):
        assert bool((pt["blocks"][name] == 1).all())
    # random leaves: another generator, the same scale (normal / sqrt(fan_in))
    w = pt["blocks"]["w_in"].float()
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05


def test_lm_params_from_numpy_keeps_bf16_exact():
    a = np.random.default_rng(0).standard_normal((5, 7)).astype(ml_dtypes.bfloat16)
    with pytest.raises(TypeError):
        torch.from_numpy(a)
    p = convert.lm_params_from_numpy({"blocks": {"w": a}, "embed": a.astype(np.float32)},
                                     device="cpu")
    assert p["blocks"]["w"].dtype == torch.bfloat16 and p["embed"].dtype == torch.float32
    np.testing.assert_array_equal(p["blocks"]["w"].float().numpy(), a.astype(np.float32))
    assert convert.lm_params_from_numpy({"w": a}, "cpu", torch.float32)["w"].dtype \
        == torch.float32


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 0.0)])
def test_layers_match_jax(dtype, tol):
    """rms_norm, interleaved-pair rotary and the MLP activations, op by op."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    g = rng.standard_normal((16,)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) / 4 for s in ((16, 24), (16, 24), (24, 16))]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    pos = np.broadcast_to(np.arange(3, 8)[None], (2, 5)).astype(np.int32)
    _close(tL.rms_norm(tx, torch.from_numpy(g).to(td)), jL.rms_norm(jx, jnp.asarray(g, jd)),
           max(tol, 4e-3 if dtype == "bfloat16" else tol))
    _close(tL.apply_rope(tx, torch.from_numpy(pos), 1e4),
           jL.apply_rope(jx, jnp.asarray(pos), 1e4), max(tol, 1e-6))
    for act in ("swiglu", "squared_relu", "gelu"):
        if dtype == "bfloat16" and act == "gelu":
            continue  # no dense-GQA config uses gelu
        got = tL.mlp(tx, *(torch.from_numpy(a).to(td) for a in w), act)
        want = jL.mlp(jx, *(jnp.asarray(a, jd) for a in w), act)
        _close(got, want, max(tol, 1e-5))


def test_rope_rotates_interleaved_pairs():
    x = torch.zeros((1, 1, 1, 4))
    x[..., 0] = 1.0  # the pair (x0, x1) = (1, 0) turns by the angle of frequency 0
    out = tL.apply_rope(x, torch.tensor([[1]]), theta=1e4)
    np.testing.assert_allclose(out[0, 0, 0].numpy(), [np.cos(1.0), np.sin(1.0), 0, 0],
                               atol=1e-6)


# ---------------------------------------------------------------------------
# forward / prefill / decode against repro.models.lm
# ---------------------------------------------------------------------------

CASES = [(a, "float32", F32_TOL) for a in DENSE_GQA] + [("granite-3-2b", "bfloat16", BF16_TOL)]


@pytest.mark.parametrize("arch,dtype,tol", CASES)
def test_forward_prefill_decode_match_jax(arch, dtype, tol):
    jcfg, tcfg = _cfgs(arch, dtype)
    pj, pt = _params(jcfg)
    B, S, max_len = 2, 12, 16
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    _close(lm.forward(pt, tcfg, torch.from_numpy(toks)),
           jlm.forward(pj, jcfg, jnp.asarray(toks)), tol)

    lj, cj = jlm.prefill(pj, jcfg, jnp.asarray(toks[:, :-1]), max_len=max_len)
    lt, ct = lm.prefill(pt, tcfg, torch.from_numpy(toks[:, :-1]), max_len=max_len)
    _close(lt, lj, tol)
    for name in ("k", "v"):
        assert ct[name].shape == cj[name].shape and ct[name].dtype == getattr(torch, dtype)
        _close(ct[name], cj[name], tol)
    assert int(ct["len"]) == int(cj["len"]) == S - 1

    dlj, cj2 = jlm.make_decode_step(jcfg)(pj, cj, jnp.asarray(toks[:, -1]))
    dlt, ct2 = lm.make_decode_step(tcfg)(pt, ct, torch.from_numpy(toks[:, -1]))
    _close(dlt, dlj, tol)  # the vocab mask included: -1e30 past cfg.vocab
    assert bool((dlt[:, tcfg.vocab:] == tL.NEG).all())
    for name in ("k", "v"):
        _close(ct2[name], cj2[name], tol)
    assert int(ct2["len"]) == int(cj2["len"]) == S


def test_decode_past_max_len_clamps_like_jax():
    """``dynamic_update_slice`` clamps its start: with len past max_len the
    new row lands in the last slot and every slot counts as filled."""
    jcfg, tcfg = _cfgs("granite-3-2b", "float32")
    pj, pt = _params(jcfg, seed=2)
    B, max_len = 2, 6
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (B, 5)).astype(np.int32)
    _, cj = jlm.prefill(pj, jcfg, jnp.asarray(toks), max_len=max_len)
    _, ct = lm.prefill(pt, tcfg, torch.from_numpy(toks), max_len=max_len)
    step_j, step_t = jlm.make_decode_step(jcfg), lm.make_decode_step(tcfg)
    for i in range(4):  # len 5 -> 9: slots 5, 5, 5, 5 once len reaches 6
        tok = rng.integers(0, jcfg.vocab, (B,)).astype(np.int32)
        lj, cj = step_j(pj, cj, jnp.asarray(tok))
        lt, ct = step_t(pt, ct, torch.from_numpy(tok))
        _close(lt, lj, F32_TOL)
        _close(ct["k"], cj["k"], F32_TOL)
    assert int(ct["len"]) == int(cj["len"]) == 9


@pytest.mark.parametrize("arch", DENSE_GQA)
def test_decode_forward_consistency(arch):
    """prefill(prompt[:-1]) + one decode step reproduce forward's last
    logits (test_archs.py's check, on the port alone)."""
    _, cfg = _cfgs(arch, "float32")
    params = lm.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)))
    h = lm.forward(params, cfg, toks)
    full = h[:, -1].float() @ params["embed"].float().T
    _, cache = lm.prefill(params, cfg, toks[:, :-1], max_len=32)
    dec, cache2 = lm.make_decode_step(cfg)(params, cache, toks[:, -1])
    err = float((dec[:, :cfg.vocab] - full[:, :cfg.vocab]).abs().max())
    assert err < CONSISTENCY_TOL, f"{arch}: decode/forward mismatch {err}"
    assert int(cache2["len"]) == 12


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "xlstm-1.3b", "zamba2-1.2b"])
def test_other_kinds_raise(arch):
    cfg = get_smoke_config(arch)
    for fn in (lambda: lm.init_params(cfg, device="cpu"),
               lambda: lm.init_cache(cfg, 1, 8, device="cpu"),
               lambda: lm.forward({}, cfg, torch.zeros((1, 2), dtype=torch.long)),
               lambda: lm.make_decode_step(cfg)):
        with pytest.raises(NotImplementedError, match="queue 1 item 14"):
            fn()


# ---------------------------------------------------------------------------
# the batched server
# ---------------------------------------------------------------------------

def test_launch_server_admit_and_step_smoke():
    """tests/test_serving.py::test_launch_server_admit_and_step_smoke."""
    cfg = get_smoke_config("granite-3-2b")
    server = serve.Server(cfg, batch=2, max_len=32, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [serve.Request(rid=i, prompt=rng.integers(1, cfg.vocab, 3), max_new=2)
            for i in range(3)]
    assert server.free_slots == 2
    assert server.admit(reqs[0]) and server.admit(reqs[1])
    assert server.free_slots == 0
    assert not server.admit(reqs[2])           # full: admission refused

    bound = serve.max_decode_steps(reqs[:2])
    finished = steps = 0
    while finished < 2 and steps <= bound:
        finished += server.step()
        steps += 1
    assert finished == 2
    assert all(r.done for r in reqs[:2])
    assert all(len(r.out) == len(r.prompt) + r.max_new for r in reqs[:2])
    assert server.free_slots == 2
    assert server.admit(reqs[2])               # slots were recycled


@pytest.mark.parametrize("max_len,n_req,max_new", [(64, 5, 4), (10, 4, 5)])
def test_server_matches_jax(max_len, n_req, max_new):
    """Same params, same requests, f32: identical output tokens. With
    max_len 10 the shared len passes max_len, which exercises the clamp."""
    jcfg, tcfg = _cfgs("granite-3-2b", "float32")
    js = jserve.Server(jcfg, batch=2, max_len=max_len, seed=0)
    ts = serve.Server(tcfg, batch=2, max_len=max_len, device="cpu",
                      params=convert.lm_params_from_numpy(
                          jax.tree.map(np.asarray, js.params), device="cpu"))
    jreqs = serve.synthetic_requests(tcfg, n_req, max_new, seed=4)
    treqs = [dataclasses.replace(r, out=[]) for r in jreqs]
    jreqs = [jserve.Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new) for r in jreqs]
    steps_t = serve.serve(ts, treqs)
    steps_j = 0
    pending = list(jreqs)
    while not all(r.done for r in jreqs):
        while pending and js.free_slots > 0 and js.admit(pending[0]):
            pending.pop(0)
        js.step()
        steps_j += 1
    assert steps_t == steps_j
    assert int(ts.cache["len"]) == int(js.cache["len"]) == steps_t
    if max_len == 10:
        assert steps_t > max_len
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(len(r.out) == len(r.prompt) + r.max_new for r in treqs)


def test_serve_main_smoke_on_cpu(capsys):
    serve.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                "--requests", "3", "--max-new", "2"])
    assert "served 3 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Appendix K: the LLM UDF query, unoptimized
# ---------------------------------------------------------------------------

def _jax_llm_udf(params, cfg):
    """examples/serve_llm_udf.py's unoptimized query, built the same way."""
    plan, catalog, calls = _jax_llm_udf_query(params, cfg)
    return j_execute(plan, catalog).canonical(), calls["n"]


def _jax_llm_udf_query(params, cfg):
    calls = {"n": 0}

    def llm_summarize(feats):
        calls["n"] += feats.shape[0]
        toks = (jnp.abs(feats[:, :16]) * 37).astype(jnp.int32) % cfg.vocab
        return jlm.forward(params, cfg, toks)[:, -1, :8]

    rng = np.random.default_rng(0)
    users = JTable.from_columns({
        "user_id": jnp.arange(24, dtype=jnp.int32),
        "user_desc": jnp.asarray(rng.standard_normal((24, 16)), jnp.float32)})
    movies = JTable.from_columns({
        "movie_id": jnp.arange(12, dtype=jnp.int32),
        "lang_en": jnp.asarray(rng.integers(0, 2, 12), jnp.int32),
        "movie_desc": jnp.asarray(rng.standard_normal((12, 16)), jnp.float32)})
    catalog = jir.Catalog()
    catalog.add("users", users)
    catalog.add("movies", movies)
    registry = JRegistry()
    registry.register(JMLFunction("llm_summarize", graph=None,
                                  opaque_fn=llm_summarize, n_inputs=1))
    registry.register(jbuilders.two_tower("recommend", [8, 16, 8], [8, 16, 8], seed=1))
    q = jir.Project(
        jir.Filter(jir.CrossJoin(jir.Scan("users"), jir.Scan("movies")),
                   pred=jir.Cmp("==", jir.Col("lang_en"), jir.Const(1))),
        outputs=(("score", jir.Call("recommend", (
            jir.Call("llm_summarize", (jir.Col("user_desc"),)),
            jir.Call("llm_summarize", (jir.Col("movie_desc"),))))),),
        keep=("user_id", "movie_id"))
    return jir.Plan(q, registry), catalog, calls


def test_llm_udf_query_matches_jax():
    """The example's config (granite smoke, vocab 256) in float32: the
    .canonical() bar of 5e-4 is below one bf16 ulp (3.9e-3)."""
    jcfg, tcfg = _cfgs("granite-3-2b", "float32", vocab=256)
    pj, pt = _params(jcfg)
    want, j_calls = _jax_llm_udf(pj, jcfg)
    plan, catalog, calls = llm_udf_query(pt, tcfg, device="cpu")
    got = execute(plan, catalog, device="cpu").canonical()
    assert_canonical_close(want, got, "llm_udf")
    assert len(got["score"]) > 0 and calls["n"] == j_calls > 0


def test_llm_udf_optimized_matches_jax():
    """examples/serve_llm_udf.py's optimized plan (vanilla MCTS, 40
    iterations, seed 0, the CPU prior in both packages): the same plan after
    the backend map, the same LLM rows summarized by each plan (fewer by
    the optimized one), and results equal to the reference's at the
    .canonical() bar. The port's ``llm_summarize`` declares its FLOPs; the
    search still pushes it below the cross join as the reference's does."""
    jcfg, tcfg = _cfgs("granite-3-2b", "float32", vocab=256)
    pj, pt = _params(jcfg)
    jplan, jcat, jcalls = _jax_llm_udf_query(pj, jcfg)
    jnaive = j_execute(jplan, jcat).canonical()
    jnaive_rows = jcalls["n"]
    sync_fresh_names()
    jopt, _ = j_vanilla_mcts(jplan, jcat, cost_fn=j_cost_fn(jcat), iterations=40, seed=0)
    jcalls["n"] = 0
    jout = j_execute(jopt, jcat).canonical()
    plan, catalog, calls = llm_udf_query(pt, tcfg, device="cpu")
    sync_fresh_names()
    r = naive_and_optimized(plan, catalog, calls, device="cpu")
    assert r["plan"].signature() == port_signature(jopt.signature())
    assert (r["naive_rows"], r["optimized_rows"]) == (jnaive_rows, jcalls["n"])
    assert r["optimized_rows"] < r["naive_rows"]
    assert_canonical_close(jnaive, r["naive"], "llm_udf naive")
    assert_canonical_close(jout, r["optimized"], "llm_udf optimized")
    assert_canonical_close(r["naive"], r["optimized"], "llm_udf optimized == naive")


def test_serve_llm_udf_main_prints_both_plans(capsys):
    from repro_torch.launch import serve_llm_udf
    serve_llm_udf.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "naive=576" in out and "optimized=32" in out
