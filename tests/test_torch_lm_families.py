"""The port's MoE, M-RoPE and encoder-decoder LMs against the JAX package, on the CPU.

granite-moe-1b-a400m (``kind="moe"``), qwen2-vl-72b (``attn="mrope"``) and
seamless-m4t-medium (``kind="encdec"``), at their smoke configs. Params
come from the JAX package's ``init_params`` and cross with
``convert.lm_params_from_numpy``; tokens, frame embeddings and M-RoPE
position ids come from a numpy seed. ``forward``, ``prefill`` (logits, the
K/V cache and the encoder's memory) and three decode steps are held to
``repro.models.lm`` at 2e-4 in float32 and 3e-2 in bfloat16 (the bars of
``test_torch_lm.py``); the ``Server``'s tokens to the JAX ``Server``'s,
seamless's over the empty encoder memory the reference serves with. The
MoE's capacity drops, its router on tied gates and M-RoPE's three position
rows each have a targeted case.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch import serve as jserve
from repro.models import layers as jL, lm as jlm
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import layers as tL, lm

FAMILIES = ("granite-moe-1b-a400m", "qwen2-vl-72b", "seamless-m4t-medium")
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


def _inputs(cfg, rng, b, s, s_enc=7, pos3=False):
    """Tokens [B,S] and the family's extra inputs, as (jax kwargs, torch kwargs)."""
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    extra = {}
    if cfg.kind == "encdec":
        extra["enc_embeds"] = rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32)
    if pos3:
        extra["pos3"] = rng.integers(0, 4 * s, (3, b, s)).astype(np.int32)
    return (toks, {k: jnp.asarray(v) for k, v in extra.items()},
            {k: torch.from_numpy(v) for k, v in extra.items()})


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_param_shapes_and_init_match_jax(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    pt = lm.init_params(tcfg, seed=0, device="cpu")
    flat_j = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(pj)}
    flat_t = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(pt)}
    assert set(flat_j) == set(flat_t)
    for k, v in flat_j.items():
        assert tuple(v.shape) == tuple(flat_t[k].shape) and flat_t[k].dtype == torch.bfloat16
        if bool((np.asarray(v, np.float32) == 1).all()):  # the reference's norms
            assert bool((flat_t[k] == 1).all()), k


# ---------------------------------------------------------------------------
# forward / prefill / decode against repro.models.lm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_forward_prefill_decode_match_jax(arch, dtype, tol):
    jcfg, tcfg = _cfgs(arch, dtype)
    pj, pt = _params(jcfg)
    B, S, max_len = 2, 12, 16
    rng = np.random.default_rng(0)
    toks, jkw, tkw = _inputs(jcfg, rng, B, S)
    _close(lm.forward(pt, tcfg, torch.from_numpy(toks), **tkw),
           jlm.forward(pj, jcfg, jnp.asarray(toks), **jkw), tol)

    lj, cj = jlm.prefill(pj, jcfg, jnp.asarray(toks[:, :-1]), max_len=max_len, **jkw)
    lt, ct = lm.prefill(pt, tcfg, torch.from_numpy(toks[:, :-1]), max_len=max_len, **tkw)
    _close(lt, lj, tol)
    assert set(ct) == set(cj)
    for name in set(cj) - {"len"}:
        assert ct[name].shape == cj[name].shape and ct[name].dtype == getattr(torch, dtype)
        _close(ct[name], cj[name], tol)
    assert int(ct["len"]) == int(cj["len"]) == S - 1

    step_j, step_t = jlm.make_decode_step(jcfg), lm.make_decode_step(tcfg)
    tok = toks[:, -1]
    for i in range(3):
        dlj, cj = step_j(pj, cj, jnp.asarray(tok))
        dlt, ct = step_t(pt, ct, torch.from_numpy(tok))
        _close(dlt, dlj, tol)
        assert bool((dlt[:, tcfg.vocab:] == tL.NEG).all())
        for name in ("k", "v"):
            _close(ct[name], cj[name], tol)
        assert int(ct["len"]) == int(cj["len"]) == S + i
        tok = rng.integers(0, jcfg.vocab, (B,)).astype(np.int32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_forward_consistency(arch):
    """prefill(prompt[:-1]) + one decode step reproduce forward's last
    logits (test_archs.py's check, on the port alone)."""
    _, cfg = _cfgs(arch, "float32")
    params = lm.init_params(cfg, seed=1, device="cpu")
    toks, _, kw = _inputs(cfg, np.random.default_rng(0), 2, 12)
    toks = torch.from_numpy(toks)
    h = lm.forward(params, cfg, toks, **kw)
    full = h[:, -1].float() @ params["embed"].float().T
    _, cache = lm.prefill(params, cfg, toks[:, :-1], max_len=32, **kw)
    dec, cache2 = lm.make_decode_step(cfg)(params, cache, toks[:, -1])
    err = float((dec[:, :cfg.vocab] - full[:, :cfg.vocab]).abs().max())
    assert err < CONSISTENCY_TOL, f"{arch}: decode/forward mismatch {err}"
    assert int(cache2["len"]) == 12


def test_encdec_decode_takes_another_memory():
    """decode_step(..., enc_h=) attends over the memory given, not the
    cache's, as the reference's does."""
    jcfg, tcfg = _cfgs("seamless-m4t-medium", "float32")
    pj, pt = _params(jcfg)
    rng = np.random.default_rng(5)
    toks, jkw, tkw = _inputs(jcfg, rng, 2, 6)
    _, cj = jlm.prefill(pj, jcfg, jnp.asarray(toks), max_len=8, **jkw)
    _, ct = lm.prefill(pt, tcfg, torch.from_numpy(toks), max_len=8, **tkw)
    mem = rng.standard_normal((2, 3, jcfg.d_model)).astype(np.float32)
    tok = toks[:, -1]
    lj, _ = jlm.make_decode_step(jcfg)(pj, cj, jnp.asarray(tok), enc_h=jnp.asarray(mem))
    lt, _ = lm.make_decode_step(tcfg)(pt, ct, torch.from_numpy(tok),
                                      enc_h=torch.from_numpy(mem))
    _close(lt, lj, F32_TOL)


def test_empty_encoder_memory_attends_to_nothing():
    """The server's encoder memory has no frames: cross-attention adds
    zero, as the reference's softmax over zero keys does."""
    jcfg, tcfg = _cfgs("seamless-m4t-medium", "float32")
    pj, pt = _params(jcfg)
    cj = jlm.init_cache(jcfg, 2, 8)
    ct = lm.init_cache(tcfg, 2, 8, device="cpu")
    assert tuple(ct["enc_h"].shape) == tuple(cj["enc_h"].shape) == (2, 0, tcfg.d_model)
    tok = np.array([3, 7], np.int32)
    lj, _ = jlm.make_decode_step(jcfg)(pj, cj, jnp.asarray(tok))
    lt, _ = lm.make_decode_step(tcfg)(pt, ct, torch.from_numpy(tok))
    assert bool(lt.isfinite().all())
    _close(lt, lj, F32_TOL)
    q = torch.ones((2, tcfg.n_heads, tcfg.hd))
    empty = torch.zeros((2, 0, tcfg.n_kv_heads, tcfg.hd))
    assert torch.equal(lm._decode_attn(q, empty, empty, 0), torch.zeros_like(q))


# ---------------------------------------------------------------------------
# MoE: capacity drops and the router's ties
# ---------------------------------------------------------------------------

def _moe_weights(cfg, rng, skew=0.0):
    mo = cfg.moe
    d, e, f = cfg.d_model, mo.n_experts, mo.d_expert
    router = rng.standard_normal((d, e)).astype(np.float32) / np.sqrt(d)
    router[:, 0] += skew  # with skew > 0, tokens of positive mean pick expert 0
    return [router] + [rng.standard_normal(s).astype(np.float32) / np.sqrt(s[-2])
                       for s in ((e, d, f), (e, d, f), (e, f, d))]


def _j_moe(jcfg, x, ws):
    """The reference's ``moe_block`` under jit, as its model runs it (XLA
    folds the router's float32 cast into the product)."""
    return jax.jit(lambda *a: jL.moe_block(*a, jcfg))(x, *ws)


def _dropped(cfg, x, router):
    """Assignments past their expert's capacity, from the reference's routing."""
    t, k = x.shape[0], cfg.moe.top_k
    gates = jax.nn.softmax(jnp.asarray(x @ router, jnp.float32), axis=-1)
    _, tope = jax.lax.top_k(gates, k)
    counts = np.bincount(np.asarray(tope).ravel(), minlength=cfg.moe.n_experts)
    return int(np.maximum(counts - tL.capacity(cfg, t), 0).sum())


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("t,skew", [(320, 0.0), (320, 1.0), (600, 2.0), (64, 2.0)])
def test_moe_block_matches_jax(t, skew, dtype, tol):
    """Past 256 tokens an expert keeps ``capacity`` assignments (the rest
    are dropped); at 64 none is. A skewed router makes one expert
    overflow."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m", dtype)
    rng = np.random.default_rng(t + int(10 * skew))
    x = (rng.standard_normal((t, jcfg.d_model)) + (0.5 if skew else 0.0)).astype(np.float32)
    ws = _moe_weights(jcfg, rng, skew)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = _j_moe(jcfg, jnp.asarray(x, jd), [jnp.asarray(w, jd) for w in ws])
    got = tL.moe_block(torch.from_numpy(x).to(td), *(torch.from_numpy(w).to(td)
                       for w in ws), tcfg)
    _close(got, want, tol)
    if t <= 256:
        assert tL.capacity(tcfg, t) == t and _dropped(tcfg, x, ws[0]) == 0
    elif skew >= 1.0:
        assert _dropped(tcfg, x, ws[0]) > 0


def test_moe_forward_past_capacity_matches_jax():
    """B 2 x S 160 = 320 tokens through the whole smoke model: each MoE
    layer routes past the dropless limit."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m", "float32")
    pj, pt = _params(jcfg, seed=3)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 160)).astype(np.int32)
    assert tL.capacity(tcfg, 320) < 320
    _close(lm.forward(pt, tcfg, torch.from_numpy(toks)),
           jlm.forward(pj, jcfg, jnp.asarray(toks)), F32_TOL)


def test_top_k_breaks_ties_like_lax():
    """Equal gates: the lower expert first, as ``jax.lax.top_k`` orders
    them (``torch.topk`` does not promise it)."""
    rng = np.random.default_rng(0)
    g = rng.choice(np.float32([0.1, 0.2, 0.3]), size=(64, 32))
    g[0, :5] = [0.1, 0.3, 0.3, 0.2, 0.3]
    for k in (1, 2, 8):
        v, i = tL.top_k(torch.from_numpy(g), k)
        jv, ji = jax.lax.top_k(jnp.asarray(g), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert tL.top_k(torch.from_numpy(g), 3)[1][0].tolist() == [1, 2, 4]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_on_tied_gates_matches_jax(dtype):
    """Integer-valued tokens and router weights give many equal logits: the
    experts chosen, and the MoE's output, are the reference's."""
    arch = "granite-moe-1b-a400m"
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype, moe=dataclasses.replace(
        c.moe, n_experts=32, top_k=8)) for c in (j_smoke(arch), get_smoke_config(arch)))
    rng = np.random.default_rng(1)
    x = rng.integers(-1, 2, (64, jcfg.d_model)).astype(np.float32)
    ws = _moe_weights(jcfg, rng)
    ws[0] = rng.integers(0, 2, ws[0].shape).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    logits = np.asarray(jnp.asarray(x, jd) @ jnp.asarray(ws[0], jd), np.float32)
    assert sum(len(r) - len(set(r)) for r in logits.tolist()) > 64 * 8  # many ties
    _, want_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1), 8)
    gates, got_e = tL.route(torch.from_numpy(x).to(td), torch.from_numpy(ws[0]).to(td), 8)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    _close(gates.sum(-1), np.ones(64), 1e-6)
    want = _j_moe(jcfg, jnp.asarray(x, jd), [jnp.asarray(w, jd) for w in ws])
    got = tL.moe_block(torch.from_numpy(x).to(td), *(torch.from_numpy(w).to(td)
                       for w in ws), tcfg)
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


def test_moe_block_on_a_mesh_raises():
    _, tcfg = _cfgs("granite-moe-1b-a400m", "float32")
    ws = [torch.from_numpy(w) for w in _moe_weights(tcfg, np.random.default_rng(0))]
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        tL.moe_block(torch.zeros((4, tcfg.d_model)), *ws, tcfg, mesh=object())


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 0.0)])
def test_apply_mrope_matches_jax(hd, dtype, tol):
    """Three distinct position rows; at hd 128 each of (t, h, w) rotates
    its own section of the frequency slots."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 5, 3, hd)).astype(np.float32)
    pos3 = rng.integers(0, 1000, (3, 2, 5)).astype(np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = tL.apply_mrope(torch.from_numpy(x).to(td), torch.from_numpy(pos3), theta=1e6)
    want = jL.apply_mrope(jnp.asarray(x, jd), jnp.asarray(pos3), theta=1e6)
    _close(got, want, max(tol, 1e-5))
    if hd == 128 and dtype == "float32":  # each row moves its own section
        for row, lo in ((1, 16), (2, 40)):
            moved = pos3.copy()
            moved[row] += 1
            other = tL.apply_mrope(torch.from_numpy(x).to(td), torch.from_numpy(moved))
            diff = (other != got).any(0).any(0).any(0).reshape(hd // 2, 2).any(1)
            assert diff.nonzero().flatten().tolist() == list(
                range(lo, lo + (24 if row else 16)))


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_prefill_with_pos3_matches_jax(dtype, tol):
    """qwen2-vl with M-RoPE ids from a seed (not the 1-D positions), at
    head dim 128 so that all three sections are live."""
    jcfg, tcfg = _cfgs("qwen2-vl-72b", dtype, head_dim=128)
    pj, pt = _params(jcfg, seed=4)
    toks, jkw, tkw = _inputs(jcfg, np.random.default_rng(4), 2, 9, pos3=True)
    _close(lm.forward(pt, tcfg, torch.from_numpy(toks), **tkw),
           jlm.forward(pj, jcfg, jnp.asarray(toks), **jkw), tol)
    lj, cj = jlm.prefill(pj, jcfg, jnp.asarray(toks), max_len=12, **jkw)
    lt, ct = lm.prefill(pt, tcfg, torch.from_numpy(toks), max_len=12, **tkw)
    _close(lt, lj, tol)
    _close(ct["k"], cj["k"], tol)
    plain, _ = lm.prefill(pt, tcfg, torch.from_numpy(toks), max_len=12)
    assert float((plain - lt).abs().max()) > 10 * tol  # the ids matter


# ---------------------------------------------------------------------------
# the batched server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("max_len,n_req,max_new", [(64, 5, 4), (10, 4, 5)])
def test_server_matches_jax(arch, max_len, n_req, max_new):
    """Same params, same requests, f32: identical output tokens; with
    max_len 10 the shared len passes max_len (the clamp). The encoder-
    decoder serves over an empty encoder memory, as the reference does."""
    jcfg, tcfg = _cfgs(arch, "float32")
    js = jserve.Server(jcfg, batch=2, max_len=max_len, seed=0)
    ts = serve.Server(tcfg, batch=2, max_len=max_len, device="cpu",
                      params=convert.lm_params_from_numpy(
                          jax.tree.map(np.asarray, js.params), device="cpu"))
    len_buf = ts.cache["len"]
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
    assert ts.cache["len"] is len_buf  # advanced in place
    assert int(ts.cache["len"]) == int(js.cache["len"]) == steps_t
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(len(r.out) == len(r.prompt) + r.max_new for r in treqs)
    assert ts.captured is None and ts.captures == 0  # the CPU runs eagerly
    if tcfg.kind == "encdec":
        assert ts.cache["enc_h"].shape[1] == 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_server_decode_is_the_eager_step(arch):
    """``Server.decode`` advances len by one and returns the greedy tokens
    of ``make_decode_step``'s logits, from the same cache."""
    _, cfg = _cfgs(arch, "float32")
    server = serve.Server(cfg, batch=2, max_len=6, device="cpu", seed=2)
    cache = {k: v.clone() for k, v in server.cache.items()}
    step = lm.make_decode_step(cfg)
    tok = torch.tensor([1, 2], dtype=torch.int32)
    for i in range(8):  # past max_len: the last slot is written again
        logits, cache = step(server.params, cache, tok)
        nxt = server.decode(tok)
        assert torch.equal(nxt, logits.argmax(-1).to(torch.int32))
        assert torch.equal(server.logits, logits)
        assert int(server.cache["len"]) == int(cache["len"]) == i + 1
        torch.testing.assert_close(server.cache["k"], cache["k"], rtol=0, atol=0)
        tok = nxt


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_main_smoke_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--requests", "3", "--max-new", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "decode step eager" in out
