"""The port's sequence-state layers (``repro_torch.models.ssm``) against the
JAX package's, on the CPU.

Inputs and weights come from a numpy seed and go to both packages; the
reference runs under ``jax.jit``, as its model always does (its layers sit
inside ``lax.scan``). Bars: 2e-4 in float32 (the LM tests' bar) and 3e-2 in
bfloat16. The chunked core is checked at S a multiple of its chunk, at a
ragged S and from a carried state; each block in both modes, with the
prefill's states carried into a decode step. In bfloat16 the port rounds
where XLA does: the cumulative sum in blocks of 16, ``jax.nn.sigmoid`` and
``jax.nn.softplus`` op for op, the decode step's gate product in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import lm as jlm, ssm as jssm
from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm

TOLS = {"float32": 2e-4, "bfloat16": 3e-2}
DTYPES = [("float32", jnp.float32, torch.float32), ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def _both(arrays, jd, td):
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(np.asarray(a, np.float32)).to(td) for a in arrays])


def _gla_inputs(rng, b, s, h, dk, dv):
    q, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    log_a = -0.3 * np.abs(rng.standard_normal((b, s, h))).astype(np.float32)
    gate = np.abs(rng.standard_normal((b, s, h))).astype(np.float32)
    return q, k, v, log_a, gate


@pytest.mark.parametrize("s,chunk", [(64, 32), (37, 16), (300, 128), (12, 128)],
                         ids=["whole-chunks", "ragged", "ragged-128", "one-short-chunk"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype,jd,td", DTYPES)
def test_chunked_gla_matches_jax(s, chunk, with_state, dtype, jd, td):
    rng = np.random.default_rng(s + chunk)
    arrays = _gla_inputs(rng, 2, s, 3, 8, 5)
    s0 = rng.standard_normal((2, 3, 8, 5)).astype(np.float32) if with_state else None
    ja, ta = _both(arrays, jd, td)
    yj, Sj = jax.jit(lambda *a: jssm.chunked_gla(
        *a, chunk=chunk, state0=None if s0 is None else jnp.asarray(s0)))(*ja)
    yt, St = ssm.chunked_gla(*ta, chunk=chunk,
                             state0=None if s0 is None else torch.from_numpy(s0))
    assert yt.shape == yj.shape and St.shape == Sj.shape and St.dtype == torch.float32
    _close(yt, yj, TOLS[dtype])
    _close(St, Sj, TOLS[dtype])


@pytest.mark.parametrize("n", [1, 12, 16, 17, 37, 128, 300])
@pytest.mark.parametrize("dtype,jd,td", DTYPES)
def test_cumsum_matches_xla(n, dtype, jd, td):
    """``jnp.cumsum`` under jit sums in blocks of 16; in bf16 the port gives
    its bits, where ``torch.cumsum`` does not."""
    x = np.random.default_rng(n).standard_normal((2, n, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(jnp.asarray(x, jd)), np.float32)
    got = ssm.cumsum(torch.from_numpy(x).to(td), dim=1).float().numpy()
    np.testing.assert_array_equal(got, want) if dtype == "bfloat16" else _close(got, want, 1e-6)


@pytest.mark.parametrize("dtype,jd,td", DTYPES)
def test_gla_decode_step_matches_jax(dtype, jd, td):
    rng = np.random.default_rng(3)
    q, k, v, log_a, gate = (a[:, 0] for a in _gla_inputs(rng, 2, 1, 3, 8, 5))
    S = rng.standard_normal((2, 3, 8, 5)).astype(np.float32)
    ja, ta = _both((q, k, v, log_a, gate), jd, td)
    yj, Sj = jax.jit(jssm.gla_decode_step)(jnp.asarray(S), *ja)
    yt, St = ssm.gla_decode_step(torch.from_numpy(S), *ta)
    _close(yt, yj, TOLS[dtype])
    _close(St, Sj, TOLS[dtype])


def test_gla_decode_continues_the_chunked_scan():
    """A prefill's final state, then one decode step, equals the chunked
    scan over the prompt and the token."""
    q, k, v, log_a, gate = (torch.from_numpy(a) for a in
                            _gla_inputs(np.random.default_rng(4), 2, 21, 3, 8, 5))
    y_all, S_all = ssm.chunked_gla(q, k, v, log_a, gate, chunk=8)
    _, S = ssm.chunked_gla(q[:, :-1], k[:, :-1], v[:, :-1], log_a[:, :-1], gate[:, :-1],
                           chunk=8)
    y, S = ssm.gla_decode_step(S, q[:, -1], k[:, -1], v[:, -1], log_a[:, -1], gate[:, -1])
    _close(y, y_all[:, -1], 1e-5)
    _close(S, S_all, 1e-5)


def _layer_params(arch, kind, rng):
    cfg = j_smoke(arch)
    shapes = {"mamba2": jlm._mamba_shapes, "mlstm": jlm._mlstm_shapes,
              "slstm": jlm._slstm_shapes}[kind](cfg, 1)
    p = {n: (rng.standard_normal(s[1:]) / np.sqrt(s[-2] if len(s) > 2 else 1)).astype(np.float32)
         for n, s in shapes.items()}
    p["ln"] = np.ones_like(p["ln"])
    if kind == "mamba2":  # the reference's init constants, then a spread
        p["dt_bias"] = -2.0 + 0.5 * rng.standard_normal(p["dt_bias"].shape).astype(np.float32)
        p["A_log"] = 0.3 * rng.standard_normal(p["A_log"].shape).astype(np.float32)
        p["D_skip"] = 1.0 + 0.1 * rng.standard_normal(p["D_skip"].shape).astype(np.float32)
    return p


BLOCKS = [("zamba2-1.2b", "mamba2"), ("xlstm-1.3b", "mlstm"), ("xlstm-1.3b", "slstm")]


@pytest.mark.parametrize("arch,kind", BLOCKS)
@pytest.mark.parametrize("s", [19, 2])
@pytest.mark.parametrize("dtype,jd,td", DTYPES)
def test_block_prefill_then_decode_matches_jax(arch, kind, s, dtype, jd, td):
    """The block over a prompt of S tokens (S 2 < the conv's window), then
    two decode steps from the states it returns, in both packages; each
    package carries its own states. The port leaves the states it is given
    as they were."""
    jcfg = dataclasses.replace(j_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    rng = np.random.default_rng(s + len(kind))
    p = _layer_params(arch, kind, rng)
    pj = {n: jnp.asarray(a, jd) for n, a in p.items()}
    pt = {n: torch.from_numpy(a).to(td) for n, a in p.items()}
    fj = getattr(jssm, f"{kind}_forward")
    ft = getattr(ssm, f"{kind}_forward")
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    oj, stj = jax.jit(lambda x, p: fj(x, p, jcfg))(jnp.asarray(x, jd), pj)
    ot, stt = ft(torch.from_numpy(x).to(td), pt, tcfg)
    tol = TOLS[dtype]
    _close(ot, oj, tol)
    assert len(stt) == len(stj)
    for a, b in zip(stt, stj):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, tol)
    step_j = jax.jit(lambda x, p, st: fj(x, p, jcfg, state=st, decode=True))
    for _ in range(2):
        x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        old, given = stt, [t.clone() for t in stt]
        oj, stj = step_j(jnp.asarray(x1, jd), pj, stj)
        ot, stt = ft(torch.from_numpy(x1).to(td), pt, tcfg, state=old, decode=True)
        assert all(torch.equal(a, b) for a, b in zip(old, given))
        _close(ot, oj, tol)
        for a, b in zip(stt, stj):
            _close(a, b, tol)


def test_conv_state_carries_the_window():
    """Prefill's conv state is its last W-1 inputs (left-padded with zeros
    under W-1 tokens): a decode step after a prefill of S-1 tokens equals
    the prefill of S tokens at its last position."""
    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"), dtype="float32")
    p = {n: torch.from_numpy(a) for n, a in
         _layer_params("zamba2-1.2b", "mamba2", np.random.default_rng(1)).items()}
    for s in (2, 3, 9):
        x = torch.randn(2, s, cfg.d_model, generator=torch.Generator().manual_seed(s))
        full, (conv_all, ssm_all) = ssm.mamba2_forward(x, p, cfg)
        _, state = ssm.mamba2_forward(x[:, :-1], p, cfg)
        assert state[0].shape == (2, cfg.conv_width - 1, cfg.ssm_expand * cfg.d_model)
        out, (conv1, ssm1) = ssm.mamba2_forward(x[:, -1:], p, cfg, state=state, decode=True)
        _close(out[:, 0], full[:, -1], 1e-5)
        _close(conv1, conv_all, 1e-6)
        _close(ssm1, ssm_all, 1e-5)


@pytest.mark.parametrize("dtype,jd,td", DTYPES)
def test_softplus_matches_jax_above_20(dtype, jd, td):
    """``jax.nn.softplus`` is logaddexp(x, 0) for every x (``F.softplus``
    switches to x above its threshold of 20); in bf16 op for op."""
    x = np.concatenate([np.linspace(-40, 40, 4001), [19.9, 20.0, 20.1, 21, 25, 30, 88, 100]])
    x = x.astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x, jd)), np.float32)
    got = ssm.softplus(torch.from_numpy(x).to(td)).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    xr = torch.from_numpy(x).to(td).float().numpy()  # x in the type computed in
    assert bool((got[x > 20] >= xr[x > 20]).all())
