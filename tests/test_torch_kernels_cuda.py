"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a CUDA card. This file imports neither JAX nor ``repro``, so
it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Shapes are those of ``tests/test_kernels.py`` and, for the attention
kernels, S on both sides of their tiles and chunks; bars 1e-4 in float32
and 3e-2 in bfloat16 (2e-4 in float32 for attention), with TF32 off. The
two GEMMs (block_matmul, fused_dense) run float32 on the TF32 tensor cores
by a three-way split: they are also held at 1e-4 at K = 4096 with N(0,1)
weights, at rows and pointers that are not 16-byte aligned (their
element-copy instance), and to bit-equal repeat calls. decision_forest is
held at the workload forests' shapes, at row and tree counts off its tiles,
at d = 4096 (rows read from global memory), at ties and out-of-range
features, and to bit-equal repeat calls. flash_attention is also held
at value head dims unlike the key's, (192, 128) and (64, 32), with ragged S
and Skv and the strided views MLA's prefill hands in; its backward
(``flash_attention_bwd``) at every pair against the plain backward, also
at S and Skv off its 128-row blocks and tiles and at G 8, two calls
bit-equal, through autograd against the CPU, and in the smoke models'
training gradients. flash_decode is also held to its
merge's tickets being private to each call: calls in flight on two streams,
and a graph replay beside an eager call, each merge their own partials.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.block_matmul import ops as bm, ref as bm_ref
from repro_torch.kernels.decision_forest import ops as df, ref as df_ref
from repro_torch.kernels.flash_attention import ops as fa, ref as fa_ref
from repro_torch.kernels.flash_decode import ops as fdec, ref as fdec_ref
from repro_torch.kernels.fused_dense import ops as fd, ref as fd_ref

F32_TOL, BF16_TOL = 1e-4, 3e-2
ATTN_TOL = 2e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, shape, dev):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(dev)


# the JAX package's kernel-test shapes, then shapes whose rows of x, w or
# out are not 16-byte aligned in one dtype or both (N or K % 8 != 0)
GEMM_SHAPES = [(10, 16, 40, 4), (130, 300, 520, 8), (64, 512, 1024, 16),
               (7, 12, 5, 2), (130, 200, 70, 3), (33, 300, 70, 3), (5, 13, 7, 1),
               (40, 36, 44, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,t", GEMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_matmul_kernel(cuda_device, m, k, n, t, dtype):
    rng = np.random.default_rng(m + n)
    td = getattr(torch, dtype)
    x, w = (_normal(rng, s, cuda_device).to(td) for s in ((m, k), (k, n)))
    before = bm.launches
    got = bm.block_matmul(x, w, t)
    assert bm.launches == before + 1 and got.dtype == td
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got.float(), bm_ref.block_matmul(x, w, t).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(7, 12, 5), (130, 200, 70), (256, 512, 128),
                                   (1, 128, 128)])
@pytest.mark.parametrize("act", fd_ref.ACTS)
def test_fused_dense_kernel(cuda_device, m, k, n, act):
    rng = np.random.default_rng(m + k + n)
    x, w, b = (_normal(rng, s, cuda_device) for s in ((m, k), (k, n), (n,)))
    before = fd.launches
    got = fd.fused_dense(x, w, b, act)
    assert fd.launches == before + 1
    torch.testing.assert_close(got, fd_ref.fused_dense(x, w, b, act),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(64, 96, 32), (7, 12, 5), (130, 200, 70),
                                   (256, 512, 128), (1, 128, 128), (33, 300, 70)])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_fused_dense_kernel_bf16(cuda_device, m, k, n, act):
    rng = np.random.default_rng(m + k + n)
    x, w, b = (_normal(rng, s, cuda_device).to(torch.bfloat16)
               for s in ((m, k), (k, n), (n,)))
    before = fd.launches
    got = fd.fused_dense(x, w, b, act)
    assert fd.launches == before + 1 and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), fd_ref.fused_dense(x, w, b, act).float(),
                               rtol=BF16_TOL, atol=BF16_TOL)
    with pytest.raises(ValueError):
        fd.fused_dense(x, w, b, "softmax")


def _gemm_tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("operand", ["x", "w"])
def test_gemm_kernels_pointer_offset(cuda_device, dtype, operand):
    """A contiguous slice that starts 4 bytes past a 16-byte boundary goes
    to the element-copy instance and gives the plain version's result."""
    rng = np.random.default_rng(7)
    td = getattr(torch, dtype)
    m, k, n = 96, 256, 160
    shape = (m, k) if operand == "x" else (k, n)
    base = _normal(rng, (shape[0] * shape[1] + 4,), cuda_device).to(td)
    offset = 4 // base.element_size()
    sliced = base[offset:offset + shape[0] * shape[1]].view(shape)
    assert sliced.is_contiguous() and sliced.data_ptr() % 16 == 4
    other = _normal(rng, (k, n) if operand == "x" else (m, k), cuda_device).to(td)
    x, w = (sliced, other) if operand == "x" else (other, sliced)
    b = _normal(rng, (n,), cuda_device).to(td)
    tol = _gemm_tol(dtype)
    before = (bm.launches, fd.launches)
    got_bm, got_fd = bm.block_matmul(x, w, 2), fd.fused_dense(x, w, b, "tanh")
    assert (bm.launches, fd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got_bm.float(), bm_ref.block_matmul(x, w, 2).float(),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(got_fd.float(), fd_ref.fused_dense(x, w, b, "tanh").float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,t", [(65, 4096, 130, 4), (300, 4096, 256, 2)])
def test_gemm_kernels_k4096_f32(cuda_device, m, k, n, t):
    """The hardest case for the three-way split: a long K with N(0,1)
    weights, where one TF32 product misses the 1e-4 bar many times over."""
    rng = np.random.default_rng(k + n)
    x, w, b = (_normal(rng, s, cuda_device) for s in ((m, k), (k, n), (n,)))
    torch.testing.assert_close(bm.block_matmul(x, w, t), bm_ref.block_matmul(x, w, t),
                               rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(fd.fused_dense(x, w, b, "identity"),
                               fd_ref.fused_dense(x, w, b, "identity"),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(300, 512, 256), (130, 200, 70)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_kernels_repeat_bit_equal(cuda_device, m, k, n, dtype):
    """No atomics: three calls in a row give the same bits, in both the
    16-byte-copy (first shape) and the element-copy instance."""
    rng = np.random.default_rng(m)
    td = getattr(torch, dtype)
    x, w, b = (_normal(rng, s, cuda_device).to(td) for s in ((m, k), (k, n), (n,)))
    before = (bm.launches, fd.launches)
    first = (bm.block_matmul(x, w, 3), fd.fused_dense(x, w, b, "sigmoid"))
    for _ in range(2):
        again = (bm.block_matmul(x, w, 3), fd.fused_dense(x, w, b, "sigmoid"))
        for got, want in zip(again, first):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (bm.launches, fd.launches) == (before[0] + 3, before[1] + 3)


def _forest(rng, n, d, t, depth, dev, feat_lo=0, feat_hi=None):
    nn = 2 ** depth - 1
    x = _normal(rng, (n, d), dev)
    feat = rng.integers(feat_lo, d if feat_hi is None else feat_hi, (t, nn))
    return (x, torch.as_tensor(feat.astype(np.int32)).to(dev),
            _normal(rng, (t, nn), dev), _normal(rng, (t, 2 ** depth), dev))


def _forest_check(args):
    before = df.launches
    got = df.forest_predict(*args)
    assert df.launches == before + 1
    torch.testing.assert_close(got, df_ref.forest_predict(*args), rtol=F32_TOL, atol=F32_TOL)
    return got


# the JAX package's kernel-test shapes; the forests of retail_q2, simple_q2,
# analytics_q1, analytics_q2 and analytics_q3; n not a multiple of the row
# tile; n < 32; T not a multiple of the tree chunk (at depth 9, 18 trees
# beside 32 rows of 29 features, 11 beside 768 rows at n = 70,000); d = 4096,
# whose 32-row tile does not fit in shared memory (the instance that reads
# rows from global memory)
FOREST_SHAPES = [(20, 8, 4, 3), (150, 16, 10, 5), (64, 29, 25, 6),
                 (3000, 32, 160, 6), (3000, 40, 50, 6), (3000, 29, 100, 9),
                 (3000, 96, 1, 9), (3000, 128, 100, 9),
                 (1001, 29, 100, 9), (7, 29, 100, 9), (70000, 29, 100, 9),
                 (500, 4096, 30, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,t,depth", FOREST_SHAPES)
def test_decision_forest_kernel(cuda_device, n, d, t, depth):
    args = _forest(np.random.default_rng(n + d), n, d, t, depth, cuda_device)
    got = _forest_check(args)
    # trees are summed in a fixed order without atomics: repeat runs agree bit for bit
    before = df.launches
    torch.testing.assert_close(got, df.forest_predict(*args), rtol=0, atol=0)
    assert df.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows,walk_trees,tsplit", [(1, 2, 8), (1, 2, 2), (1, 4, 1),
                                                    (2, 2, 1), (3, 2, 1), (4, 2, 1)])
@pytest.mark.parametrize("stage_x", [True, False])
@pytest.mark.parametrize("stages", [1, 2])
def test_decision_forest_kernel_instances(cuda_device, rows, walk_trees, tsplit,
                                          stage_x, stages):
    """Every kernel instance, with one and two tree buffers and with the
    trees split over 1, 2 and 8 groups of warps, at n and T off its row
    tile, tree chunk and walk group."""
    n, d, t, depth = 2500, 29, 23, 9
    threads, chunk = 256, 5
    bm = threads // tsplit * rows
    tiling = df.ForestTiling(bm=bm, threads=threads, rows=rows, walk_trees=walk_trees,
                             chunk=chunk, stages=stages, tsplit=tsplit, stage_x=stage_x,
                             smem=(bm * d * 4 if stage_x else 0)
                             + stages * chunk * df.tree_bytes(depth))
    args = _forest(np.random.default_rng(rows + 10 * stages + tsplit), n, d, t, depth,
                   cuda_device)
    before = df.launches
    got = df.launch(*args, tiling)
    assert df.launches == before + 1
    torch.testing.assert_close(got, df_ref.forest_predict(*args), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.cuda
def test_decision_forest_kernel_no_rows(cuda_device):
    """n = 0 gives an empty result and launches nothing, as before."""
    args = _forest(np.random.default_rng(0), 0, 29, 100, 9, cuda_device)
    before = df.launches
    got = df.forest_predict(*args)
    assert got.shape == (0,) and got.device.type == "cuda" and df.launches == before


@pytest.mark.cuda
def test_decision_forest_kernel_ties(cuda_device):
    """x and thresholds on a few integers: many compares tie, and a tie goes
    left (strict >)."""
    x, feat, thresh, leaf = _forest(np.random.default_rng(1), 3000, 29, 40, 9, cuda_device)
    _forest_check((x.round(), feat, thresh.round(), leaf))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(3000, 29), (500, 4096)])
def test_decision_forest_kernel_clamps_feat(cuda_device, n, d):
    """feat below 0 and at or above d clamps to [0, d-1], as JAX's gathers
    do, in both instances (rows staged and rows from global memory)."""
    _forest_check(_forest(np.random.default_rng(2), n, d, 30, 9, cuda_device,
                          feat_lo=-40, feat_hi=d + 40))


@pytest.mark.cuda
def test_kernels_refuse_non_contiguous(cuda_device):
    x = torch.ones((8, 6), device=cuda_device).t()
    with pytest.raises(ValueError):
        bm.block_matmul(x, torch.ones((8, 4), device=cuda_device))


def _attn_tol(dtype):
    return ATTN_TOL if dtype == "float32" else BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d", [(2, 4, 2, 37, 16), (1, 8, 8, 256, 64),
                                          (2, 6, 3, 100, 32), (1, 4, 1, 70, 128),
                                          (1, 2, 1, 65, 160)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel(cuda_device, b, hq, hkv, s, d, causal, dtype):
    rng = np.random.default_rng(s + d)
    td = getattr(torch, dtype)
    q, k, v = (_normal(rng, sh, cuda_device).to(td)
               for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal)
    assert fa.launches == before + 1 and got.dtype == td and got.shape == q.shape
    want = fa_ref.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2), causal=causal).transpose(1, 2)
    tol = _attn_tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 160])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_bf16_edges(cuda_device, d, s, causal):
    """The tensor-core instance at every head dim, S on both sides of its
    64-key and 128-row tiles."""
    rng = np.random.default_rng(s * d)
    q, k, v = (_normal(rng, sh, cuda_device).to(torch.bfloat16)
               for sh in ((2, 4, s, d), (2, 2, s, d), (2, 2, s, d)))
    got = fa.flash_attention(q, k, v, causal)
    want = fa_ref.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2), causal=causal).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(64, "float32"), (128, "bfloat16")])
def test_flash_attention_kernel_strided_views(cuda_device, d, dtype):
    """[B,S,H,D] projections go in as transposed views, as the model passes
    them; the output keeps q's layout, so its transpose back is contiguous."""
    rng = np.random.default_rng(5)
    td = getattr(torch, dtype)
    b, s, hq, hkv = 2, 130, 8, 2
    qs, ks, vs = (_normal(rng, sh, cuda_device).to(td)
                  for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    got = fa.flash_attention(qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    want = fa_ref.flash_attention_plain(qs, ks, vs, causal=True)
    tol = _attn_tol(dtype)
    torch.testing.assert_close(got.transpose(1, 2).float(), want.float(), rtol=tol, atol=tol)


# (D, Dv) pairs unlike each other: MLA's prefill (deepseek-v2) and the narrow
# pair of the card's MLA test config; S and Skv ragged against the tiles
MLA_PAIRS = [(192, 128), (64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", MLA_PAIRS)
@pytest.mark.parametrize("b,hq,hkv,s,skv", [(2, 4, 4, 1, 1), (1, 4, 4, 129, 129),
                                            (2, 6, 3, 70, 200), (1, 2, 2, 300, 65)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_value_dim(cuda_device, d, dv, b, hq, hkv, s, skv, causal,
                                          dtype):
    """q and k of head dim D, v of Dv, as [B,S,H,*] tensors handed in as
    transposed views, v a slice of a wider projection as MLA's prefill
    takes it: [B,Hq,S,Dv] out, in q's layout, at the plain version's values."""
    rng = np.random.default_rng(d + dv + s + skv)
    td = getattr(torch, dtype)
    qs = _normal(rng, (b, s, hq, d), cuda_device).to(td)
    ks = _normal(rng, (b, skv, hkv, d), cuda_device).to(td)
    kvb = _normal(rng, (b, skv, hkv, 48 + dv), cuda_device).to(td)
    vs = kvb[..., 48:]  # strides of the [.., nope + v] projection, as the model's
    before = fa.launches
    got = fa.flash_attention(qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2),
                             causal)
    assert fa.launches == before + 1
    assert got.shape == (b, hq, s, dv) and got.dtype == td
    assert got.transpose(1, 2).is_contiguous()
    want = fa_ref.flash_attention_plain(qs, ks, vs, causal=causal)
    tol = _attn_tol(dtype)
    torch.testing.assert_close(got.transpose(1, 2).float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [(24, 16), (128, 64)])
def test_flash_attention_kernel_refuses_other_pairs(cuda_device, d, dv):
    q = torch.zeros((1, 2, 8, d), device=cuda_device, dtype=torch.bfloat16)
    v = torch.zeros((1, 2, 8, dv), device=cuda_device, dtype=torch.bfloat16)
    before = fa.launches
    with pytest.raises(ValueError, match="not instantiated"):
        fa.flash_attention(q, q, v)
    assert fa.launches == before


# ---------------------------------------------------------------------------
# flash_attention's backward (csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------

BWD_PAIRS = [(16, 16), (32, 32), (64, 64), (128, 128), (160, 160), (192, 128), (64, 32)]


def _bwd_inputs(rng, b, hq, hkv, s, skv, d, dv, dtype, dev):
    """q, k, v, do as [B,H,S,D] views of [B,S,H,D] tensors (the model's
    layout), and the plain forward's o and lse for them."""
    td = getattr(torch, dtype)
    q, k, v, do = (_normal(rng, sh, dev).to(td).transpose(1, 2)
                   for sh in ((b, s, hq, d), (b, skv, hkv, d), (b, skv, hkv, dv),
                              (b, s, hq, dv)))
    return q, k, v, do


def _plain_bwd(q, k, v, do, causal):
    t = lambda x: x.transpose(1, 2)
    o, lse = fa_ref.flash_attention_plain(t(q), t(k), t(v), causal=causal, return_lse=True)
    grads = fa_ref.flash_attention_bwd_plain(t(q), t(k), t(v), o, lse, t(do), causal)
    return t(o), t(lse), [t(g) for g in grads]


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", BWD_PAIRS)
@pytest.mark.parametrize("shape", [(2, 4, 2, 37, 37), (1, 4, 1, 130, 130), (1, 2, 2, 70, 45)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel(cuda_device, d, dv, shape, causal, dtype):
    """Every instantiated pair, G 1/2/4, ragged S and Skv off the 64-row
    tiles, against the plain backward on the same o and lse."""
    b, hq, hkv, s, skv = shape
    rng = np.random.default_rng(d + dv + s)
    q, k, v, do = _bwd_inputs(rng, b, hq, hkv, s, skv, d, dv, dtype, cuda_device)
    o, lse, want = _plain_bwd(q, k, v, do, causal)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    assert fa.bwd_launches == before + 1
    tol = _attn_tol(dtype)
    layout = lambda t: [st for st, n in zip(t.stride(), t.shape) if n > 1]
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype and layout(g) == layout(x), name
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"{name}: {m}")


# (B, Hq, Hkv, S, Skv) at the edges of the tensor-core instances' tiles (128
# keys a dK/dV block, 128 rows a dQ block, streamed tiles of 64 or 128
# rows): S and Skv one off 128 and 256 on either side, unequal; G 8
# (qwen2-vl's 64 / 8); and causal diagonals crossing a 128-key block that S
# and Skv both cut short
BWD_EDGE_SHAPES = [(1, 8, 1, 127, 129), (1, 8, 1, 129, 127), (2, 16, 2, 257, 129),
                   (1, 8, 1, 257, 257), (1, 4, 2, 192, 257)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", BWD_PAIRS)
@pytest.mark.parametrize("shape", BWD_EDGE_SHAPES, ids=lambda s: "b{}h{}-{}s{}kv{}".format(*s))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_at_tile_edges(cuda_device, d, dv, shape, causal, dtype):
    """Every pair at S and Skv off the 128-row blocks and the 64- or
    128-row streamed tiles, against the plain backward on the same o and
    lse."""
    b, hq, hkv, s, skv = shape
    rng = np.random.default_rng(d + dv + s + skv)
    q, k, v, do = _bwd_inputs(rng, b, hq, hkv, s, skv, d, dv, dtype, cuda_device)
    o, lse, want = _plain_bwd(q, k, v, do, causal)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    tol = _attn_tol(dtype)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_deterministic_and_lse_leaves_forward_unchanged(cuda_device, dtype):
    """Two backward calls give the same bits (no atomics); the forward
    with lse gives the bits of the forward without it, and its lse is the
    plain version's."""
    rng = np.random.default_rng(3)
    q, k, v, do = _bwd_inputs(rng, 2, 8, 2, 300, 300, 64, 64, dtype, cuda_device)
    o_plain, lse_plain, _ = _plain_bwd(q, k, v, do, True)
    o, lse = fa._forward(q, k, v, True, with_lse=True)
    assert torch.equal(o, fa.flash_attention(q, k, v, True))
    torch.testing.assert_close(lse, lse_plain, rtol=ATTN_TOL, atol=ATTN_TOL)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_fn_on_card(cuda_device, dtype):
    """Autograd through ``flash_attention``: one forward and one backward
    launch; the gradients reach [B,S,H,D] leaves, k given in another
    layout than q ([B,H,S,D] contiguous) and do with stride 0 (the backward
    of a sum), against the CPU's plain path."""
    rng = np.random.default_rng(4)
    td = getattr(torch, dtype)
    qn, kn, vn = (rng.standard_normal(sh).astype(np.float32)
                  for sh in ((2, 40, 4, 32), (2, 2, 40, 32), (2, 40, 2, 32)))
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        q, k, v = (torch.from_numpy(x).to(dev, td).requires_grad_() for x in (qn, kn, vn))
        before = (fa.launches, fa.bwd_launches)
        o = fa.flash_attention(q.transpose(1, 2), k, v.transpose(1, 2), True)
        (o.float().sum() * 0.5).backward()
        launched = (fa.launches - before[0], fa.bwd_launches - before[1])
        assert launched == ((1, 1) if dev.type == "cuda" else (0, 0))
        assert k.grad.stride() == k.stride()
        results.append([t.float().cpu() for t in (o, q.grad, k.grad, v.grad)])
    tol = _attn_tol(dtype)
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_attention_bwd_refuses_other_pairs(cuda_device):
    x = torch.zeros((1, 2, 8, 24), device=cuda_device)
    lse = torch.zeros((1, 2, 8), device=cuda_device)
    before = fa.bwd_launches
    with pytest.raises(ValueError, match="not instantiated"):
        fa.flash_attention_bwd(x, x, x, x, lse, x)
    assert fa.bwd_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v2-236b", "seamless-m4t-medium",
                                  "zamba2-1.2b"])
def test_lm_train_step_on_card_matches_cpu(cuda_device, arch):
    """The smoke config's loss and gradients in float32 through the kernels
    (forward and backward) on the card against the plain versions on the
    CPU, every leaf at 2e-4 of its largest |g|; one forward launch a layer
    and attention (twice under remat) and one backward launch each."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", remat=True)
    if cfg.attn == "mla":  # the kernel's (64, 32) pair
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, nope_dim=48, rope_dim=16, v_dim=32))
    p_cpu = lm.init_params(cfg, seed=0, device="cpu")
    to = lambda tree, dev: {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                            for k, v in tree.items()}
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40))),
             "labels": torch.from_numpy(rng.integers(-1, cfg.vocab, (2, 40)))}
    if cfg.kind == "encdec":
        batch["enc_embeds"] = torch.from_numpy(
            rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32))
    before = (fa.launches, fa.bwd_launches)
    loss_g, grads_g = lm.value_and_grad(to(p_cpu, cuda_device), cfg, to(batch, cuda_device))
    fwd, bwd = fa.launches - before[0], fa.bwd_launches - before[1]
    # every forward again under remat, but the hybrid's shared block
    assert bwd > 0 and fwd == (1 if cfg.kind == "hybrid" else 2) * bwd
    loss_c, grads_c = lm.value_and_grad(p_cpu, cfg, batch)
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-4, atol=1e-4)
    from repro_torch.train.optim import tree_leaves
    for g, c in zip(tree_leaves(grads_g), tree_leaves(grads_c)):
        scale = float(c.abs().max())
        torch.testing.assert_close(g.cpu(), c, rtol=ATTN_TOL, atol=ATTN_TOL * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,g,d,s", [(4, 6, 32, 300), (2, 8, 64, 1024),
                                      (1, 1, 16, 50), (3, 4, 160, 520)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel(cuda_device, bh, g, d, s, dtype):
    rng = np.random.default_rng(bh + s)
    td = getattr(torch, dtype)
    q, k, v = (_normal(rng, sh, cuda_device).to(td)
               for sh in ((bh, g, d), (bh, s, d), (bh, s, d)))
    before = fdec.launches
    got = fdec.decode_partials(q, k, v)
    assert fdec.launches == before + 1
    want = fdec_ref.decode_partials_plain(q, k[:, :, None], v[:, :, None], s, d ** -0.5)
    for x, y in zip(got, want):
        assert x.dtype == torch.float32
        torch.testing.assert_close(x, y[:, 0], rtol=ATTN_TOL, atol=ATTN_TOL)
    torch.testing.assert_close(fdec.decode_attention(q, k, v),
                               fdec_ref.decode_attention(q, k, v),
                               rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.cuda
def test_flash_decode_kernel_shard_merge(cuda_device):
    rng = np.random.default_rng(0)
    bh, g, d, s = 3, 4, 32, 384
    q, k, v = (_normal(rng, sh, cuda_device) for sh in ((bh, g, d), (bh, s, d), (bh, s, d)))
    parts = [fdec.decode_partials(q, k[:, lo:hi], v[:, lo:hi])
             for lo, hi in [(0, 128), (128, 256), (256, 384)]]
    torch.testing.assert_close(fdec_ref.merge_partials(*zip(*parts)),
                               fdec_ref.decode_attention(q, k, v),
                               rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("filled", [1, 127, 128, 129, 255, 256, 513, 700, 1024, 1500])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_model_cache(cuda_device, filled, dtype):
    """The model's call: cache [B,S,Hkv,D] read through strides, the filled
    length as an int32 on the card (past S it means all slots)."""
    rng = np.random.default_rng(filled)
    td = getattr(torch, dtype)
    b, hq, hkv, s, d = 4, 32, 8, 1024, 64
    q = _normal(rng, (b, hq, d), cuda_device).to(td)
    kc, vc = (_normal(rng, (b, s, hkv, d), cuda_device).to(td) for _ in range(2))
    n = torch.tensor(filled, dtype=torch.int32, device=cuda_device)
    got = fdec.gqa_decode_partials(q, kc, vc, n)
    want = fdec_ref.decode_partials_plain(q, kc, vc, filled, d ** -0.5)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_repeats_and_graph_replays(cuda_device, dtype):
    """The chunks' partials are merged in the same launch by the last block
    of each (b, h), found through a ticket it resets: three calls in a row
    and three replays of a captured call give the same result."""
    rng = np.random.default_rng(3)
    td = getattr(torch, dtype)
    b, hq, hkv, s, d = 4, 32, 8, 1024, 64
    q = _normal(rng, (b, hq, d), cuda_device).to(td)
    kc, vc = (_normal(rng, (b, s, hkv, d), cuda_device).to(td) for _ in range(2))
    n = torch.tensor(700, dtype=torch.int32, device=cuda_device)
    first = fdec.gqa_decode_partials(q, kc, vc, n)
    for x, y in zip(first, fdec_ref.decode_partials_plain(q, kc, vc, 700, d ** -0.5)):
        torch.testing.assert_close(x, y, rtol=ATTN_TOL, atol=ATTN_TOL)
    outs = [fdec.gqa_decode_partials(q, kc, vc, n) for _ in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fdec.gqa_decode_partials(q, kc, vc, n)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fdec.gqa_decode_partials(q, kc, vc, n)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        outs.append([x.clone() for x in captured])
    for out in outs:
        for x, y in zip(out, first):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def _decode_cache(rng, dev, s=4096, filled=3996, d=64):
    """A bf16 cache [1, S, 1, D] with ``filled`` slots: one (b, h), so every
    block of every call in flight takes the same ticket, and at most 64
    blocks a call, so calls on two streams run side by side."""
    kc, vc = (_normal(rng, (1, s, 1, d), dev).to(torch.bfloat16) for _ in range(2))
    return kc, vc, torch.tensor(filled, dtype=torch.int32, device=dev)


def _decode_want(q, cache):
    """The plain partials' merged attention: what a call must return."""
    kc, vc, n = cache
    return fdec_ref.merge_partials(
        *([x] for x in fdec_ref.decode_partials_plain(q, kc, vc, n, q.shape[-1] ** -0.5)))


def _merged(parts):
    return fdec_ref.merge_partials(*([x] for x in parts))


def _gate(streams):
    """Hold ``streams`` behind a ~0.2 s device sleep (4e8 clocks), far
    longer than the host takes to enqueue the calls meant to overlap, so
    that they all start when it ends."""
    gate = torch.cuda.Stream()
    gate.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(gate):
        torch.cuda._sleep(400_000_000)
    ev = torch.cuda.Event()
    ev.record(gate)
    for st in streams:
        st.wait_event(ev)


@pytest.mark.cuda
def test_flash_decode_kernel_two_streams(cuda_device):
    """Calls with different inputs in flight on two streams at once (no
    sync between them) each merge their own partials: four long calls (64
    blocks of two chunks each) on one stream while twelve short ones (8
    blocks with work) run on the other, so their blocks finish interleaved."""
    rng = np.random.default_rng(7)
    caches = [_decode_cache(rng, cuda_device, 16384, 16000),
              _decode_cache(rng, cuda_device, 4096, 1000)]
    calls = [(0, _normal(rng, (1, 4, 64), cuda_device).to(torch.bfloat16)) for _ in range(4)]
    calls += [(1, _normal(rng, (1, 4, 64), cuda_device).to(torch.bfloat16)) for _ in range(12)]
    for i in (0, 1):  # first calls of each shape outside the gated window
        fdec.gqa_decode_partials(calls[-i][1], *caches[i])
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    _gate(streams)
    outs = []
    for i, q in calls:
        with torch.cuda.stream(streams[i]):
            outs.append(fdec.gqa_decode_partials(q, *caches[i]))
    torch.cuda.synchronize()
    for n, ((i, q), parts) in enumerate(zip(calls, outs)):
        torch.testing.assert_close(_merged(parts), _decode_want(q, caches[i]),
                                   rtol=ATTN_TOL, atol=ATTN_TOL, msg=lambda m: f"call {n}: {m}")


@pytest.mark.cuda
def test_flash_decode_kernel_graph_replay_beside_eager_call(cuda_device):
    """A CUDA-graph replay on one stream while eager calls with other
    inputs run on another: both results are right."""
    rng = np.random.default_rng(8)
    g_cache, e_cache = (_decode_cache(rng, cuda_device) for _ in range(2))
    g_q = _normal(rng, (1, 4, 64), cuda_device).to(torch.bfloat16)
    e_qs = [_normal(rng, (1, 4, 64), cuda_device).to(torch.bfloat16) for _ in range(4)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fdec.gqa_decode_partials(g_q, *g_cache)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fdec.gqa_decode_partials(g_q, *g_cache)
    torch.cuda.synchronize()
    g_want = _decode_want(g_q, g_cache)
    replay_st, eager_st = torch.cuda.Stream(), torch.cuda.Stream()
    for rep in range(4):
        _gate([replay_st, eager_st])
        with torch.cuda.stream(replay_st):
            graph.replay()
        eager = []
        for q in e_qs:
            with torch.cuda.stream(eager_st):
                eager.append(fdec.gqa_decode_partials(q, *e_cache))
        torch.cuda.synchronize()
        torch.testing.assert_close(_merged(captured), g_want, rtol=ATTN_TOL, atol=ATTN_TOL,
                                   msg=lambda m: f"replay {rep}: {m}")
        for q, parts in zip(e_qs, eager):
            torch.testing.assert_close(_merged(parts), _decode_want(q, e_cache),
                                       rtol=ATTN_TOL, atol=ATTN_TOL,
                                       msg=lambda m: f"eager beside replay {rep}: {m}")


@pytest.mark.cuda
def test_attention_kernels_refuse_bad_operands(cuda_device):
    x = torch.ones((1, 2, 8, 24), device=cuda_device)  # head dim 24: no instance
    with pytest.raises(ValueError):
        fa.flash_attention(x, x, x)
    y = torch.ones((1, 2, 16, 8), device=cuda_device).transpose(2, 3)  # D stride 16
    with pytest.raises(ValueError):
        fa.flash_attention(y, y, y)
    q = torch.ones((2, 9, 16), device=cuda_device)  # group of 9 > 8
    kv = torch.ones((2, 40, 16), device=cuda_device)
    with pytest.raises(ValueError):
        fdec.decode_partials(q, kv, kv)
    kv_odd = torch.ones((2, 41 * 16 + 1), device=cuda_device)[:, 1:].view(2, 41, 16)
    with pytest.raises(ValueError):  # rows not 16-byte aligned
        fdec.decode_partials(torch.ones((2, 4, 16), device=cuda_device), kv_odd, kv_odd)


@pytest.mark.cuda
def test_lm_smoke_on_card_matches_cpu(cuda_device):
    """granite's smoke config in float32: forward, prefill and a decode step
    through the kernels on the card against the plain versions on the CPU."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), dtype="float32")
    p_cpu = lm.init_params(cfg, seed=0, device="cpu")
    p_gpu = {"embed": p_cpu["embed"].to(cuda_device),
             "final_norm": p_cpu["final_norm"].to(cuda_device),
             "blocks": {k: w.to(cuda_device) for k, w in p_cpu["blocks"].items()}}
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)))
    before = (fa.launches, fdec.launches)
    h = lm.forward(p_gpu, cfg, toks.to(cuda_device))
    lg, cache = lm.prefill(p_gpu, cfg, toks[:, :-1].to(cuda_device), max_len=64)
    dl, _ = lm.make_decode_step(cfg)(p_gpu, cache, toks[:, -1].to(cuda_device))
    assert (fa.launches - before[0], fdec.launches - before[1]) == (2 * cfg.n_layers,
                                                                    cfg.n_layers)
    h_c = lm.forward(p_cpu, cfg, toks)
    lg_c, cache_c = lm.prefill(p_cpu, cfg, toks[:, :-1], max_len=64)
    dl_c, _ = lm.make_decode_step(cfg)(p_cpu, cache_c, toks[:, -1])
    for got, want in ((h, h_c), (lg, lg_c), (dl, dl_c)):
        torch.testing.assert_close(got.cpu(), want, rtol=ATTN_TOL, atol=ATTN_TOL)


def _opcheck_args(name, dtype, dev):
    """Arguments of kernel operator ``name`` on the card in ``dtype``; the
    attention operands as the model hands them in ([B,H,S,D] views of
    [B,S,H,D] tensors)."""
    g = torch.Generator(device=dev).manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    if name == "block_matmul":
        return (r(130, 200), r(200, 70), 3)
    if name == "fused_dense":
        return (r(130, 200), r(200, 70), r(70), "gelu")
    if name == "forest_predict":
        return (r(300, 29), torch.randint(0, 29, (5, 63), generator=g, device=dev,
                                          dtype=torch.int32), r(5, 63), r(5, 64))
    bshd = lambda b, s, h, d: r(b, s, h, d).transpose(1, 2)
    q, k, v = bshd(2, 129, 4, 64), bshd(2, 129, 2, 64), bshd(2, 129, 2, 64)
    if name == "flash_attention":
        return (q, k, v, True, True)
    if name == "flash_attention_bwd":
        o, lse = torch.ops.repro_torch.flash_attention(q, k, v, True, True)
        return (q, k, v, o, lse, torch.randn_like(o), True)
    dq, kc, vc = r(2, 8, 64), r(2, 300, 2, 64), r(2, 300, 2, 64)
    if name == "flash_decode":
        return (dq, kc, vc, torch.tensor(37, dtype=torch.int32, device=dev))
    return (dq, kc, vc, 37)


OPCHECK = [(n, dt) for n in ("block_matmul", "fused_dense", "flash_attention",
                              "flash_attention_bwd", "flash_decode", "flash_decode_n")
           for dt in ("float32", "bfloat16")] + [("forest_predict", "float32")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", OPCHECK, ids=[f"{n}-{d}" for n, d in OPCHECK])
def test_kernel_operator_opcheck(cuda_device, name, dtype):
    """``torch.library.opcheck`` of each kernel operator on the card: its
    schema, autograd registration and shape-only (fake) implementation,
    whose shapes, dtypes and strides must be the kernel's (launch analysis
    traces the model on them)."""
    op = getattr(torch.ops.repro_torch, name).default
    torch.library.opcheck(op, _opcheck_args(name, getattr(torch, dtype), cuda_device))
