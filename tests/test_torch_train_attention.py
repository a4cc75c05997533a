"""flash_attention's gradient in the port against JAX's, on the CPU.

The reference trains through the autodiff of ``jnp_flash_attention``
(``repro.models.layers``); the port's training path goes through
``ops.FlashAttentionFn``, whose backward on CPU tensors is
``ref.flash_attention_bwd_plain`` (on the card, the kernels of
``csrc/flash_attention_bwd.cu``, held to the same plain version in
``tests/test_torch_kernels_cuda.py``). Both are held here to ``jax.vjp`` of
the reference's function at the same numpy inputs and cotangent, in
float32 at 2e-4: groups of 1, 2 and 4 query heads a KV head, causal and
not, a KV length unlike the queries' and off the chunk, and MLA's narrow
(64, 32) head-dim pair. The forward's log-sum-exp is held to a direct
``logsumexp`` of the masked scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro_torch.kernels.flash_attention import ops as t_fa, ref as t_fa_ref

ATTN_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op threads spin when the test workers share the cores;
    one thread keeps a module's small CPU ops fast under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CASES = [  # b, s, skv, hq, hkv, d, dv
    (2, 37, 37, 4, 4, 16, 16),    # G 1
    (1, 64, 64, 4, 2, 32, 32),    # G 2
    (2, 50, 50, 8, 2, 64, 64),    # G 4
    (1, 40, 29, 4, 2, 16, 16),    # Skv < S
    (1, 21, 45, 4, 1, 32, 32),    # Skv > S, G 4
    (1, 33, 33, 4, 4, 64, 32),    # MLA's narrow (64, 32) pair
]


def _inputs(seed, b, s, skv, hq, hkv, d, dv):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, hq, d), (b, skv, hkv, d), (b, skv, hkv, dv), (b, s, hq, dv))]


def _close(got, want, tol=ATTN_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _jax_grads(q, k, v, do, causal, chunk=1024):
    fn = lambda q, k, v: jL.jnp_flash_attention(q, k, v, causal=causal, chunk=chunk)
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return out, vjp(jnp.asarray(do))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}s{}kv{}h{}-{}d{}-{}".format(*c))
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_matches_jax_vjp(case, causal):
    """The plain backward, over one KV chunk and over chunks of 16."""
    q, k, v, do = _inputs(sum(case), *case)
    out, want = _jax_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = t_fa_ref.flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
    _close(o, out)
    for chunk in (1024, 16):
        got = t_fa_ref.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal, chunk=chunk)
        for g, w, t in zip(got, want, (tq, tk, tv)):
            assert g.shape == t.shape and g.dtype == t.dtype
            _close(g, w)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}s{}kv{}h{}-{}d{}-{}".format(*c))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fn_matches_jax_vjp(case, causal):
    """``flash_attention`` under autograd on [B,H,S,D] views of [B,S,H,D]
    leaves, as the model calls it: the gradients reach the leaves in their
    layout, with no kernel launch on the CPU."""
    q, k, v, do = _inputs(sum(case) + 1, *case)
    out, want = _jax_grads(q, k, v, do, causal, chunk=16)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = (t_fa.launches, t_fa.bwd_launches)
    o = t_fa.flash_attention(*(x.transpose(1, 2) for x in leaves), causal=causal)
    assert o.grad_fn is not None and "FlashAttentionFn" in type(o.grad_fn).__name__
    _close(o.transpose(1, 2), out)
    o.transpose(1, 2).backward(torch.from_numpy(do))
    assert (t_fa.launches, t_fa.bwd_launches) == before
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w)


def test_flash_attention_without_grad_takes_the_plain_path():
    """No input requires grad, or grad mode is off: today's path, no
    autograd node."""
    q, k, v, _ = _inputs(0, *CASES[1])
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    assert t_fa.flash_attention(tq, tk, tv).grad_fn is None
    with torch.no_grad():
        assert t_fa.flash_attention(tq.requires_grad_(), tk, tv).grad_fn is None
    assert t_fa.flash_attention(tq, tk, tv).grad_fn is not None


@pytest.mark.parametrize("causal", [True, False])
def test_lse_is_the_rows_logsumexp(causal):
    b, s, skv, hq, hkv, d, dv = CASES[4]
    q, k, v, _ = _inputs(3, b, s, skv, hq, hkv, d, dv)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _, lse = t_fa_ref.flash_attention_plain(tq, tk, tv, causal=causal, chunk=16,
                                            return_lse=True)
    assert lse.shape == (b, s, hq) and lse.dtype == torch.float32
    kk = tk.repeat_interleave(hq // hkv, dim=2)
    sc = torch.einsum("bshd,bchd->bhsc", tq, kk) * d ** -0.5
    if causal:
        sc = sc.masked_fill(~torch.ones(s, skv, dtype=torch.bool).tril(), -1e30)
    _close(lse, torch.logsumexp(sc, -1).transpose(1, 2))
    # the wrapper's lse is the same rows in its [B, H, S] layout
    _, lse_w = t_fa._forward(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                             causal, with_lse=True)
    _close(lse_w, lse.transpose(1, 2))


def test_cpu_path_takes_any_head_dim():
    """(24, 24) is no kernel instance: on CPU tensors the plain versions
    take it (on the card it raises, tests/test_torch_kernels_cuda.py)."""
    q, k, v, do = _inputs(5, 1, 8, 8, 2, 2, 24, 24)
    leaves = [torch.from_numpy(x).transpose(1, 2).requires_grad_() for x in (q, k, v)]
    o = t_fa.flash_attention(*leaves)
    o.backward(torch.from_numpy(do).transpose(1, 2))
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in leaves)


@pytest.mark.parametrize("d,dv", [(64, 64), (192, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,skv", [(40, 29), (21, 45)], ids=["skv<s", "skv>s"])
def test_bwd_flops_counts_the_plain_backwards_products(d, dv, causal, s, skv):
    """``ops.bwd_flops`` against the plain backward's matrix products, as
    ``FlopCounterMode`` counts them over every (row, key) pair, scaled to
    the pairs the mask keeps (counted from the same rows and keys)."""
    from torch.utils.flop_counter import FlopCounterMode
    b, hq, hkv = 2, 4, 2
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, b, s, skv, hq, hkv, d, dv))
    o, lse = t_fa_ref.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    with FlopCounterMode(display=False) as counter:
        t_fa_ref.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    rows, keys = torch.arange(s)[:, None], torch.arange(skv)[None, :]
    kept = int((rows >= keys).sum()) if causal else s * skv
    assert counter.get_total_flops() == 2 * b * hq * s * skv * (3 * d + 2 * dv)
    assert t_fa.bwd_flops(b, hq, s, skv, d, dv, causal) * s * skv == \
        counter.get_total_flops() * kept
