"""Wall-clock measurement of plans and closures on the port's device.

The port of ``benchmarks/common.py``'s helpers, shared by the examples and
the benchmark suites. Where the reference waits with
``jax.block_until_ready``, every timed call here ends in
``torch.cuda.synchronize()`` on each CUDA device its result lives on (or on
the ``device`` the caller names); on the CPU the call has finished when it
returns.

A first call always runs outside the timed window. On the card it is where
a kernel is first used, and a kernel's first use builds it with ``nvcc``:
on a cold build directory its seconds include that build.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import ir
from repro_torch.core import physical as ph
from repro_torch.core.lowering import lower
from repro_torch.core.plan_cache import PlanCache
from repro_torch.relational.table import Table


def _devices(out) -> set:
    """The devices of the tensors in a result: a Table, a tensor, or a
    dict/tuple/list of them."""
    if isinstance(out, (torch.Tensor, Table)):
        return {out.device}
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return set().union(*(_devices(v) for v in out))
    return set()


def block_until_ready(out, device=None):
    """Wait until the device has computed ``out``: synchronize ``device``, or
    every CUDA device ``out`` lives on when none is named. Returns ``out``."""
    devices = {torch.device(device)} if device is not None else _devices(out)
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out


def time_plan(plan: ir.Plan, catalog: ir.Catalog, repeats: int = 3,
              cache: Optional[PlanCache] = None) -> Tuple[float, float]:
    """Returns (median wall seconds, first-call seconds) of running ``plan``
    over the catalog's tables.

    Without ``cache`` a call is ``physical.run`` of the plan that
    ``lowering.lower`` chose under the profile of the catalog's device,
    eagerly. With ``cache`` it is ``cache.get_or_compile``'s executable: on
    the card the replay of one captured CUDA graph. The first-call seconds
    stand for the reference's compile seconds: the lowering (or the cache's
    lookup) plus the first eager run or the capture, and, on a cold build
    directory, the ``nvcc`` build of every kernel the plan uses first."""
    tables = dict(catalog.tables)
    t0 = time.perf_counter()
    if cache is not None:
        run_tables = cache.get_or_compile(plan, catalog)
        run = lambda: run_tables(tables)  # noqa: E731
    else:
        pplan = lower(plan, catalog)
        run = lambda: ph.run(pplan, tables)  # noqa: E731
    block_until_ready(run())
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        block_until_ready(run())
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], first_s


def best_time(fn: Callable, repeats: int = 9, device=None) -> float:
    """Min over repeats: the standard noise-robust microbenchmark estimator
    (load spikes only ever add time). The first call runs outside the
    window, warming (on the card: building) whatever the closure touches."""
    block_until_ready(fn(), device)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        block_until_ready(fn(), device)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def time_fn(fn: Callable, *args, repeats: int = 5, device=None) -> float:
    """Median seconds of ``fn(*args)`` after one call outside the window."""
    block_until_ready(fn(*args), device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        block_until_ready(fn(*args), device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def csv_line(name: str, us_per_call: float, derived: str = "") -> str:
    return f"{name},{us_per_call:.1f},{derived}"
