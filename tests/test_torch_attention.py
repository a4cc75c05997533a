"""The port's attention wrappers against the JAX package, on the CPU.

On CPU tensors ``flash_attention`` and the flash_decode wrappers run their
plain versions (``repro_torch.models.layers``); they are held against the
JAX wrappers in Pallas interpret mode and against the jnp twins the JAX
model runs, at the shapes and the 2e-4 bar of ``tests/test_kernels.py``.
Value head dims unlike the key's (MLA's prefill at 192 / 128, the smoke
config's 24 / 16) and MLA's latent decode attention are held the same way.
The CUDA kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa, ref as j_fa_ref
from repro.kernels.flash_decode import ops as j_fd, ref as j_fd_ref
from repro.models import layers as jL, lm as jlm
from repro_torch.kernels.flash_attention import ops as t_fa, ref as t_fa_ref
from repro_torch.kernels.flash_decode import ops as t_fd, ref as t_fd_ref
from repro_torch.models import layers as tL, lm as tlm

ATTN_TOL = 2e-4  # test_flash_attention / test_flash_decode


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, tol=ATTN_TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,hq,hkv,s,d", [(2, 4, 2, 37, 16), (1, 8, 8, 256, 64),
                                          (2, 6, 3, 100, 32),
                                          # ragged S at the card kernel's tile
                                          # edges, its widest head dims, group 8
                                          (1, 2, 1, 1, 16), (1, 4, 2, 63, 64),
                                          (1, 4, 2, 65, 128), (1, 8, 1, 129, 160)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(b, hq, hkv, s, d, causal):
    q, k, v = _inputs(s + d, (b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))
    want = j_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    before = t_fa.launches
    got = t_fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal)
    assert t_fa.launches == before  # CPU tensors: the plain version, no launch
    assert got.shape == (b, hq, s, d)
    _close(got, want)
    # and the naive oracles of both packages agree
    kk = np.repeat(k, hq // hkv, 1).reshape(b * hq, s, d)
    vv = np.repeat(v, hq // hkv, 1).reshape(b * hq, s, d)
    qq = q.reshape(b * hq, s, d)
    _close(t_fa_ref.attention(*map(torch.from_numpy, (qq, kk, vv)), causal),
           j_fa_ref.attention(jnp.asarray(qq), jnp.asarray(kk), jnp.asarray(vv), causal))


@pytest.mark.parametrize("s,skv,chunk,causal,hd", [
    (37, 37, 16, True, 16), (20, 45, 8, True, 16), (33, 19, 1024, False, 16),
    (65, 130, 64, True, 64)], ids=["37-37-16-True", "20-45-8-True", "33-19-1024-False",
                                   "65-130-64-True-hd64"])
def test_flash_attention_plain_matches_jnp_twin(s, skv, chunk, causal, hd):
    """Several chunks, a ragged last chunk and Skv != S, against
    ``jnp_flash_attention`` with the same arguments, in [B,S,H,hd]."""
    q, k, v = _inputs(s + skv, (2, s, 6, hd), (2, skv, 3, hd), (2, skv, 3, hd))
    want = jL.jnp_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, chunk=chunk)
    got = tL.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("bh,g,d,s", [(4, 6, 32, 300), (2, 8, 64, 1024),
                                      (1, 1, 16, 50),
                                      # S on both sides of the card kernel's
                                      # 128-slot chunk (64 at D 160 in bf16)
                                      (2, 4, 64, 127), (2, 4, 64, 128),
                                      (2, 4, 64, 129), (1, 8, 160, 65)])
def test_flash_decode_matches_pallas(bh, g, d, s):
    q, k, v = _inputs(bh + s, (bh, g, d), (bh, s, d), (bh, s, d))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(t_fd.decode_attention(tq, tk, tv), j_fd.decode_attention(jq, jk, jv))
    for got, want in zip(t_fd.decode_partials(tq, tk, tv), j_fd.decode_partials(jq, jk, jv)):
        _close(got, want)
    _close(t_fd_ref.decode_attention(tq, tk, tv), j_fd_ref.decode_attention(jq, jk, jv))
    for got, want in zip(t_fd_ref.decode_partials(tq, tk, tv),
                         j_fd_ref.decode_partials(jq, jk, jv)):
        _close(got, want)


def test_flash_decode_shard_merge():
    """Partials over three cache shards, merged, equal the full softmax."""
    bh, g, d, s = 3, 4, 32, 384
    q, k, v = _inputs(7, (bh, g, d), (bh, s, d), (bh, s, d))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    parts = [t_fd.decode_partials(tq, tk[:, lo:hi], tv[:, lo:hi])
             for lo, hi in [(0, 128), (128, 256), (256, 384)]]
    merged = t_fd_ref.merge_partials(*zip(*parts))
    want = j_fd_ref.decode_attention(*map(jnp.asarray, (q, k, v)))
    _close(merged, want)
    jparts = [j_fd.decode_partials(*map(jnp.asarray, (q, k[:, lo:hi], v[:, lo:hi])))
              for lo, hi in [(0, 128), (128, 256), (256, 384)]]
    _close(merged, j_fd_ref.merge_partials(*map(list, zip(*jparts))))


@pytest.mark.parametrize("valid_len", [1, 13, 40, 64, 127, 128, 129, 257])
def test_decode_partials_valid_len_matches_jnp_twin(valid_len):
    """``valid_len < S`` masks the unfilled slots, as ``_decode_partials_jnp``
    does; the model's wrapper takes the length as a tensor too. Past 64 the
    cache has 512 slots: lengths on both sides of the card kernel's 128-slot
    chunk and one past half the cache."""
    b, hq, hkv, d = 2, 8, 2, 16
    s = 64 if valid_len <= 64 else 512
    q, k, v = _inputs(valid_len, (b, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    want = jL._decode_partials_jnp(*map(jnp.asarray, (q, k, v)), valid_len, d ** -0.5)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for lens in (valid_len, torch.tensor(valid_len, dtype=torch.int32)):
        got_plain = tL.decode_partials_plain(tq, tk, tv, lens, d ** -0.5)
        got_ops = t_fd.gqa_decode_partials(tq, tk, tv, lens)
        for gp, go, w in zip(got_plain, got_ops, want):
            assert gp.shape == w.shape
            _close(gp, w)
            _close(go, w)


def test_wrappers_refuse_bad_operands():
    x = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError):
        t_fa.flash_attention(x, torch.zeros((1, 3, 8, 16)), torch.zeros((1, 3, 8, 16)))
    with pytest.raises(TypeError):
        t_fa.flash_attention(x, x.double(), x.double())
    with pytest.raises(ValueError):
        t_fd.decode_partials(torch.zeros((2, 4, 16)), torch.zeros((2, 8, 32)),
                             torch.zeros((2, 8, 32)))
    with pytest.raises(ValueError):
        t_fd.gqa_decode_partials(torch.zeros((2, 6, 16)), torch.zeros((2, 8, 4, 16)),
                                 torch.zeros((2, 8, 4, 16)), 3)


@pytest.mark.parametrize("d,dv,hq,hkv,s,skv,causal", [
    (192, 128, 4, 4, 70, 70, True),     # deepseek-v2's prefill, all heads KV heads
    (24, 16, 4, 4, 12, 12, True),       # the deepseek-v2 smoke config
    (24, 16, 6, 3, 20, 45, False),      # Skv != S, G 2
    (64, 32, 2, 2, 130, 130, True)])    # the narrow instance of the card tests
def test_flash_attention_plain_takes_another_value_dim(d, dv, hq, hkv, s, skv, causal):
    """[B,S,H,D] q and k with [B,Skv,Hkv,Dv] v against the jnp twin with
    MLA's scale D**-0.5; the wrapper's CPU path gives [B,Hq,S,Dv]."""
    q, k, v = _inputs(d + dv + s, (2, s, hq, d), (2, skv, hkv, d), (2, skv, hkv, dv))
    want = jL.jnp_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, scale=d ** -0.5, chunk=64)
    got = tL.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=causal, chunk=64)
    assert got.shape == (2, s, hq, dv)
    _close(got, want)
    via_ops = t_fa.flash_attention(*(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)),
                                   causal=causal)
    assert via_ops.shape == (2, hq, s, dv)
    _close(via_ops.transpose(1, 2), want)


@pytest.mark.parametrize("valid_len", [1, 7, 16, 29])
def test_mla_latent_attention_matches_jax(valid_len):
    """The reference's ``_mla_latent_attention`` without a mesh: scores of
    the latent and rotary parts over the first ``valid_len`` of 29 slots."""
    b, h, kv_lora, rope, s = 2, 4, 32, 8, 29
    q_c, q_pe, ckv, kpe = _inputs(valid_len, (b, h, kv_lora), (b, h, rope), (b, s, kv_lora),
                                  (b, s, rope))
    scale = (16 + rope) ** -0.5
    want = jlm._mla_latent_attention(*map(jnp.asarray, (q_c, q_pe, ckv, kpe)),
                                     jnp.asarray(valid_len), scale, None)
    for n in (valid_len, torch.tensor(valid_len, dtype=torch.int32)):
        got = tlm.mla_latent_attention(*map(torch.from_numpy, (q_c, q_pe, ckv, kpe)), n, scale)
        _close(got, want)
    # bf16 caches, as the model keeps them: read in float32 by both
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q_pe, ckv, kpe)]
    want = jlm._mla_latent_attention(jnp.asarray(q_c), *bf, valid_len, scale, None)
    got = tlm.mla_latent_attention(torch.from_numpy(q_c), *(
        torch.from_numpy(np.asarray(x, np.float32)).bfloat16() for x in bf), valid_len, scale)
    _close(got, want)


@pytest.mark.parametrize("d,dv", [(24, 16), (192, 64), (128, 64), (96, 96)])
def test_uninstantiated_head_dims_raise(d, dv):
    """A (D, Dv) pair the kernel does not instantiate raises ValueError on
    the kernel's path (any tensor not on the CPU; meta tensors here), and V
    is never padded to D nor handed to the plain version."""
    assert (d, dv) not in t_fa.HEAD_DIMS
    with pytest.raises(ValueError, match="not instantiated"):
        t_fa.check_instance(d, dv)
    q, k = (torch.empty((1, 2, 8, d), device="meta") for _ in range(2))
    v = torch.empty((1, 2, 8, dv), device="meta")
    before = t_fa.launches
    with pytest.raises(ValueError, match="not instantiated"):
        t_fa.flash_attention(q, k, v)
    assert t_fa.launches == before
    for pair in ((192, 128), (64, 32), (64, 64)):
        t_fa.check_instance(*pair)
