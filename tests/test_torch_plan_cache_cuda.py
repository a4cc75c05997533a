"""The compiled-plan cache and the engine kernels' batching rules, on the card.

Captured executables have no CPU mode, so every test here is marked
``cuda`` and skips without a CUDA card. This file imports neither JAX nor
``repro``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_plan_cache_cuda.py

A captured executable (``PlanCache.get_or_compile`` on the card: one
CUDA-graph replay a call) equals the eager run of the same lowered plan on
the 12 workloads at scale 1.0, kernel and torch plans, on three rolled
instances, at the ``.canonical()`` bar (5e-4, masks and int columns exact),
with one capture and the kernels counted once, at capture. Results returned
by earlier calls survive later replays; eviction releases the graph's pool;
each engine kernel's batching rule launches the kernel once for a whole
vmapped batch and equals a loop of its plain version (1e-4); a capture that
fails raises.
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.core import ir, physical as ph
from repro_torch.core.lowering import lower
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.rules import kernel_plan
from repro_torch.data import workloads as twl
from repro_torch.kernels.block_matmul import ops as bm, ref as bm_ref
from repro_torch.kernels.decision_forest import ops as df, ref as df_ref
from repro_torch.kernels.fused_dense import ops as fd, ref as fd_ref
from repro_torch.mlfuncs.functions import MLFunction
from repro_torch.mlfuncs.registry import Registry
from repro_torch.relational.table import Table
from repro_torch.testing import assert_canonical_close

F32_TOL = 1e-4
NAMES = sorted(twl.ALL_WORKLOADS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: captured executables have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launches():
    return bm.launches, df.launches, fd.launches


def _eager(cache, plan, catalog, backend, tables):
    """What ``execute`` computes for ``tables``: the plan lowered under the
    cache's profile, run eagerly."""
    pplan = lower(plan, catalog, backend=backend, profile=cache.profile)
    return ph.run(pplan, dict(tables))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["kernel", "torch"])
@pytest.mark.parametrize("name", NAMES)
def test_captured_equals_execute(cuda_device, name, path):
    w = twl.ALL_WORKLOADS[name](scale=1.0, device=cuda_device)
    plan, backend = ((kernel_plan(w.plan, w.catalog), None) if path == "kernel"
                     else (w.plan, "torch"))
    cache = PlanCache(device=cuda_device)
    run = cache.get_or_compile(plan, w.catalog, backend=backend)
    tabs = twl.rolled_instances(dict(w.catalog.tables), 3)
    before = _launches()
    outs = [run(t).canonical() for t in tabs]
    captured = tuple(b - a for a, b in zip(before, _launches()))
    for i, (t, out) in enumerate(zip(tabs, outs)):
        want = _eager(cache, plan, w.catalog, backend, t).canonical()
        assert_canonical_close(want, out, f"{name}/{path} instance {i}")
    assert cache.traces == 1 and run.pool_bytes >= 0
    # the counters count at capture (warm-up and capture), never at replay
    assert all(n % 2 == 0 for n in captured), captured
    if path == "torch":
        assert captured == (0, 0, 0)


@pytest.mark.cuda
def test_results_survive_later_replays(cuda_device):
    w = twl.ALL_WORKLOADS["analytics_q1"](scale=1.0, device=cuda_device)
    plan = kernel_plan(w.plan, w.catalog)
    cache = PlanCache(device=cuda_device)
    run = cache.get_or_compile(plan, w.catalog)
    first_tabs, second_tabs = twl.rolled_instances(dict(w.catalog.tables), 2)
    first = run(first_tabs)
    second = run(second_tabs)
    torch.cuda.synchronize()
    for tabs, got in ((first_tabs, first), (second_tabs, second)):
        want = _eager(cache, plan, w.catalog, None, tabs).canonical()
        assert_canonical_close(want, got.canonical(), "kept result")
    assert first.valid.data_ptr() != second.valid.data_ptr()


@pytest.mark.cuda
def test_eviction_releases_the_pool(cuda_device):
    w = twl.ALL_WORKLOADS["rec_q3"](scale=1.0, device=cuda_device)
    cache = PlanCache(maxsize=1, device=cuda_device)
    run = cache.get_or_compile(w.plan, w.catalog, backend="torch")
    out = run(dict(w.catalog.tables))
    del out
    pool = run.pool_bytes
    assert pool > 0 and run.built
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved(cuda_device)
    cache.get_or_compile(w.plan, w.catalog)  # another key: evicts the first
    assert cache.stats.evictions == 1 and not run.built and run.pool_bytes == 0
    gc.collect()
    torch.cuda.empty_cache()
    assert held - torch.cuda.memory_reserved(cuda_device) >= pool


@pytest.mark.cuda
def test_vmap_rules_launch_once(cuda_device):
    rng = np.random.default_rng(0)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(cuda_device)

    x, w, b = t((4, 300, 64)), t((64, 96)), t((96,))
    depth, trees = 5, 7
    feat = torch.as_tensor(rng.integers(0, 64, (trees, 2 ** depth - 1)).astype(np.int32)
                           ).to(cuda_device)
    thresh, leaf = t((trees, 2 ** depth - 1)), t((trees, 2 ** depth))
    cases = [
        (bm, lambda xi: bm.block_matmul(xi, w, 4), lambda xi: bm_ref.block_matmul(xi, w, 4)),
        (fd, lambda xi: fd.fused_dense(xi, w, b, "relu"),
         lambda xi: fd_ref.fused_dense(xi, w, b, "relu")),
        (df, lambda xi: df.forest_predict(xi, feat, thresh, leaf),
         lambda xi: df_ref.forest_predict(xi, feat, thresh, leaf)),
    ]
    for mod, kernel, plain in cases:
        before = mod.launches
        out = torch.func.vmap(kernel)(x)
        torch.cuda.synchronize()
        assert mod.launches == before + 1
        loop = torch.stack([plain(xi) for xi in x])
        torch.testing.assert_close(out, loop, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.cuda
def test_capture_that_fails_raises(cuda_device):
    """A plan whose body waits for the device (an opaque function reading a
    value on the host) runs eagerly but cannot be captured: the executable
    raises, with no eager fallback, and stays unbuilt."""
    reg = Registry()
    reg.register(MLFunction("host_read", opaque_fn=lambda x: x * float(x.sum())))
    cat = ir.Catalog()
    cat.add("t", Table.from_columns({"x": np.arange(64, dtype=np.float32)},
                                    device=cuda_device))
    plan = ir.Plan(ir.Project(ir.Scan("t"),
                              outputs=(("y", ir.Call("host_read", (ir.Col("x"),))),)),
                   reg)
    cache = PlanCache(device=cuda_device)
    run = cache.get_or_compile(plan, cat)
    with pytest.raises(RuntimeError):
        run(dict(cat.tables))
    assert cache.traces == 1 and not run.built
    torch.cuda.synchronize()
