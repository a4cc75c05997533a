"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a CUDA card. This file imports neither JAX nor ``repro``, so
it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Shapes are those of ``tests/test_kernels.py``; bars 1e-4 in float32 and
3e-2 in bfloat16, with TF32 off.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.block_matmul import ops as bm, ref as bm_ref
from repro_torch.kernels.decision_forest import ops as df, ref as df_ref
from repro_torch.kernels.fused_dense import ops as fd, ref as fd_ref

F32_TOL, BF16_TOL = 1e-4, 3e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, shape, dev):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,t", [(10, 16, 40, 4), (130, 300, 520, 8),
                                     (64, 512, 1024, 16)])
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
def test_fused_dense_kernel_bf16(cuda_device):
    rng = np.random.default_rng(0)
    x, w, b = (_normal(rng, s, cuda_device).to(torch.bfloat16)
               for s in ((64, 96), (96, 32), (32,)))
    torch.testing.assert_close(fd.fused_dense(x, w, b, "relu").float(),
                               fd_ref.fused_dense(x, w, b, "relu").float(),
                               rtol=BF16_TOL, atol=BF16_TOL)
    with pytest.raises(ValueError):
        fd.fused_dense(x, w, b, "softmax")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,t,depth", [(20, 8, 4, 3), (150, 16, 10, 5),
                                         (64, 29, 25, 6)])
def test_decision_forest_kernel(cuda_device, n, d, t, depth):
    rng = np.random.default_rng(n + d)
    nn = 2 ** depth - 1
    x = _normal(rng, (n, d), cuda_device)
    feat = torch.as_tensor(rng.integers(0, d, (t, nn)).astype(np.int32)).to(cuda_device)
    thresh, leaf = _normal(rng, (t, nn), cuda_device), _normal(rng, (t, 2 ** depth), cuda_device)
    before = df.launches
    got = df.forest_predict(x, feat, thresh, leaf)
    assert df.launches == before + 1
    torch.testing.assert_close(got, df_ref.forest_predict(x, feat, thresh, leaf),
                               rtol=F32_TOL, atol=F32_TOL)
    # trees are summed in a fixed order without atomics: repeat runs agree bit for bit
    torch.testing.assert_close(got, df.forest_predict(x, feat, thresh, leaf), rtol=0, atol=0)


@pytest.mark.cuda
def test_kernels_refuse_non_contiguous(cuda_device):
    x = torch.ones((8, 6), device=cuda_device).t()
    with pytest.raises(ValueError):
        bm.block_matmul(x, torch.ones((8, 4), device=cuda_device))
