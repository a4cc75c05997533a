"""The port's training step against the JAX package's, on the CPU.

``lm.loss_fn`` and its gradients (``lm.value_and_grad``, autograd through
``FlashAttentionFn`` and the plain backward on CPU tensors) are held to
``jax.jit(jax.value_and_grad(repro.models.lm.loss_fn))`` for all ten smoke
configs in float32 at 2e-4, every gradient leaf against 2e-4 of its own
largest |g| (the same weights from ``testing.seeded_lm_params``; tokens,
labels with -1s, frame embeddings and M-RoPE ids from a numpy seed; S 40
against a loss chunk of 16, so the last chunk is padded). In bfloat16 only
the loss is held (3e-2): XLA fuses the bf16 cotangents under jit, which no
op-by-op port reproduces, as ROADMAP §3's jit-versus-eager notes found for
the forward. The MoE's gradients are held at a capacity that drops tokens;
remat on equals remat off; ``make_train_step`` at microbatches 1 and 2
(qwen2-vl splits ``pos3`` on its axis 1) equals the reference's jitted
step after two AdamW steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, get_smoke_config as j_smoke
from repro.models import layers as jL, lm as jlm
from repro.train.optim import AdamW as JAdamW
from repro_torch import convert, testing
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as tL, lm
from repro_torch.train.optim import AdamW, tree_leaves

F32_TOL, BF16_TOL = 2e-4, 3e-2
ARCHS = sorted(J_ARCHS)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op threads spin when the test workers share the cores;
    one thread keeps a module's small CPU ops fast under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(j_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw))


def _params(tcfg, seed=0):
    """The same float32 weights for both packages, each in its type."""
    tree = testing.seeded_lm_params(lm.param_shapes(tcfg), seed)
    jdt = jnp.bfloat16 if tcfg.dtype == "bfloat16" else jnp.float32
    return (jax.tree.map(lambda a: jnp.asarray(a, jdt), tree),
            convert.lm_params_from_numpy(jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jdt)),
                                                      tree), device="cpu"))


def _batch(cfg, seed, b=2, s=40):
    """Tokens, labels (a fifth of them -1) and the family's extra inputs,
    as (jax batch, torch batch)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < 0.2] = -1
    out["labels"] = labels
    if cfg.kind == "encdec":
        out["enc_embeds"] = rng.standard_normal((b, 7, cfg.d_model)).astype(np.float32)
    if cfg.attn == "mrope":
        out["pos3"] = rng.integers(0, 4 * s, (3, b, s)).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _tflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_tflat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _close_tree(got, want, tol):
    """Every leaf within ``tol`` of its own largest |value| (and relatively)."""
    want, got = _flat(want), _tflat(got)
    assert set(want) == set(got)
    for key, w in want.items():
        g = got[key].detach().float().numpy()
        w = w.astype(np.float32)
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * float(np.abs(w).max()),
                                   err_msg=key)


def _j_value_and_grad(jcfg, pj, jb):
    return jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, jcfg, b)))(pj, jb)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    pj, pt = _params(tcfg)
    jb, tb = _batch(tcfg, seed=1)
    assert tb["tokens"].shape[1] % tcfg.loss_chunk  # a padded last chunk
    jl, jg = _j_value_and_grad(jcfg, pj, jb)
    tl, tg = lm.value_and_grad(pt, tcfg, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(float(lm.loss_fn(pt, tcfg, tb)), float(jl),
                               rtol=F32_TOL, atol=F32_TOL)
    _close_tree(tg, jg, F32_TOL)
    # the params are left as they were: no grad on them, no graph kept
    assert all(not w.requires_grad and w.grad is None for w in tree_leaves(pt))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    pj, pt = _params(tcfg)
    jb, tb = _batch(tcfg, seed=2)
    want = jax.jit(lambda p, b: jlm.loss_fn(p, jcfg, b))(pj, jb)
    np.testing.assert_allclose(float(lm.loss_fn(pt, tcfg, tb)), float(want),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_loss_masks_labels_and_counts_one_at_least():
    """All labels -1: the loss is 0 / max(0, 1) = 0, as the reference's."""
    jcfg, tcfg = _cfgs("granite-3-2b")
    pj, pt = _params(tcfg)
    jb, tb = _batch(tcfg, seed=3, s=20)
    jb["labels"] = jnp.full_like(jb["labels"], -1)
    tb["labels"] = torch.full_like(tb["labels"], -1)
    assert float(lm.loss_fn(pt, tcfg, tb)) == float(jlm.loss_fn(pj, jcfg, jb)) == 0.0


def test_moe_block_grads_past_capacity_match_jax():
    """600 tokens on a skewed router: expert 0 overflows and drops
    assignments; their gradient is zero (the drop row's, discarded), and
    every input's gradient is the reference's scatter's."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
    rng = np.random.default_rng(7)
    t, d = 600, jcfg.d_model
    x = (rng.standard_normal((t, d)) + 0.5).astype(np.float32)
    mo = jcfg.moe
    router = (rng.standard_normal((d, mo.n_experts)) / np.sqrt(d)).astype(np.float32)
    router[:, 0] += 2.0
    ws = [router] + [(rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
                     for s in ((mo.n_experts, d, mo.d_expert), (mo.n_experts, d, mo.d_expert),
                               (mo.n_experts, mo.d_expert, d))]
    gates = jax.nn.softmax(jnp.asarray(x @ router), axis=-1)
    counts = np.bincount(np.asarray(jax.lax.top_k(gates, mo.top_k)[1]).ravel(),
                         minlength=mo.n_experts)
    assert (counts > tL.capacity(tcfg, t)).any()  # tokens are dropped
    ct = rng.standard_normal((t, d)).astype(np.float32)
    fn = jax.jit(lambda *a: jL.moe_block(*a, jcfg))
    want_y, vjp = jax.vjp(fn, jnp.asarray(x), *map(jnp.asarray, ws))
    want = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(a).requires_grad_() for a in [x] + ws]
    y = tL.moe_block(*leaves, tcfg)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=F32_TOL,
                               atol=F32_TOL)
    y.backward(torch.from_numpy(ct))
    for name, leaf, w in zip(("x", "router", "e_gate", "e_in", "e_out"), leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=F32_TOL,
                                   atol=F32_TOL * float(np.abs(w).max()), err_msg=name)


def test_moe_model_grads_past_capacity_match_jax():
    """B 2 x S 160 = 320 tokens through the whole smoke model: each MoE
    layer routes past the dropless limit."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
    pj, pt = _params(tcfg, seed=3)
    jb, tb = _batch(tcfg, seed=3, s=160)
    assert tL.capacity(tcfg, 320) < 320
    jl, jg = _j_value_and_grad(jcfg, pj, jb)
    tl, tg = lm.value_and_grad(pt, tcfg, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=F32_TOL, atol=F32_TOL)
    _close_tree(tg, jg, F32_TOL)


@pytest.mark.parametrize("arch", ["granite-3-2b", "seamless-m4t-medium", "deepseek-v2-236b",
                                  "zamba2-1.2b", "xlstm-1.3b"])
def test_remat_on_equals_remat_off(arch, monkeypatch):
    """Rematerialized layers and CE chunks give the same loss and
    gradients, bit for bit; the reference's sites are the ones taken (a
    decoder's layers, the Mamba-2 or mLSTM layers, the CE chunks)."""
    _, tcfg = _cfgs(arch)
    _, pt = _params(tcfg)
    _, tb = _batch(tcfg, seed=4)
    calls = []
    real = lm.checkpoint
    monkeypatch.setattr(lm, "checkpoint", lambda fn, *a, **kw: calls.append(fn.__name__)
                        or real(fn, *a, **kw))
    off = lm.value_and_grad(pt, dataclasses.replace(tcfg, remat=False), tb)
    assert calls == []
    on = lm.value_and_grad(pt, dataclasses.replace(tcfg, remat=True), tb)
    n_chunks = -(-tb["tokens"].shape[1] // tcfg.loss_chunk)
    n_layers = (tcfg.n_layers + tcfg.enc_layers if tcfg.kind == "encdec" else
                tcfg.n_layers - tcfg.n_layers // tcfg.slstm_every if tcfg.kind == "xlstm"
                else tcfg.n_layers)
    body = {"hybrid": "mamba", "xlstm": "m_body"}.get(tcfg.kind, "layer")
    assert calls == [body] * n_layers + ["ce"] * n_chunks
    assert torch.equal(on[0], off[0])
    for a, b in zip(tree_leaves(on[1]), tree_leaves(off[1])):
        assert torch.equal(a, b)
    # no remat outside training: prefill takes no checkpoint
    calls.clear()
    lm.prefill(pt, dataclasses.replace(tcfg, remat=True), tb["tokens"][:, :8], max_len=16,
               **({"enc_embeds": tb["enc_embeds"]} if "enc_embeds" in tb else {}))
    assert calls == []


def test_layers_unbind_each_stack_once():
    """A layer's weights are views of one unbind per stacked leaf, so the
    backward writes each stack's gradient once (a select per layer writes
    a zero tensor of the whole stack per layer)."""
    _, tcfg = _cfgs("granite-3-2b")
    _, pt = _params(tcfg)
    blocks = {k: w.detach().requires_grad_() for k, w in pt["blocks"].items()}
    layers = lm._layers(blocks)
    assert len(layers) == tcfg.n_layers and set(layers[0]) == set(blocks)
    for i, blk in enumerate(layers):
        for name, w in blk.items():
            assert type(w.grad_fn).__name__.startswith("UnbindBackward")
            assert w.data_ptr() == blocks[name][i].data_ptr()


@pytest.mark.parametrize("arch,microbatches", [("granite-3-2b", 1), ("granite-3-2b", 2),
                                               ("qwen2-vl-72b", 2)])
def test_train_step_matches_jax(arch, microbatches):
    """Two steps of ``make_train_step`` with AdamW: the params, the
    moments and the losses equal the reference's jitted step. AdamW's eps
    is 1e-3 here: at the default 1e-8 its first step moves a weight by
    about ``lr * sign(g)``, so a gradient element within rounding of zero
    (both packages' sums agree to ~1e-6 of the largest) may move either
    way in either package; at 1e-3 the update is a smooth function of g."""
    jcfg, tcfg = _cfgs(arch)
    pj, pt = _params(tcfg)
    jopt, topt = JAdamW(lr=1e-2, eps=1e-3), AdamW(lr=1e-2, eps=1e-3)
    jstep = jax.jit(jlm.make_train_step(jcfg, jopt, microbatches=microbatches))
    tstep = lm.make_train_step(tcfg, topt, microbatches=microbatches)
    js, ts = jopt.init(pj), topt.init(pt)
    for i in range(2):
        jb, tb = _batch(tcfg, seed=10 + i, b=4, s=24)
        pj, js, jm = jstep(pj, js, jb)
        pt, ts, tm = tstep(pt, ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=F32_TOL,
                                   atol=F32_TOL)
    _close_tree(pt, pj, F32_TOL)
    _close_tree(ts.mu, js.mu, F32_TOL)
    assert int(ts.step) == int(js.step) == 2
