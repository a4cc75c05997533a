"""The decision_forest kernel's tiling (``ops.forest_tiling``), on the CPU.

The kernel runs only on the card (``tests/test_torch_kernels_cuda.py``); what
it is launched with is chosen here in Python: the row tile BM, threads and
rows a thread, trees walked at once, trees staged per chunk, tree buffers,
whether rows are staged in shared memory, and the shared-memory bytes. The
forests are the ones the 12 workloads' kernel paths hand the wrapper,
recorded by running those paths on the CPU at a small scale.
"""
import functools

import pytest

from repro_torch.core.executor import execute
from repro_torch.core.rules import kernel_plan
from repro_torch.data.workloads import ALL_WORKLOADS
from repro_torch.kernels.decision_forest import ops

SCALE = 0.05
FOREST_WORKLOADS = ("analytics_q1", "analytics_q2", "analytics_q3", "retail_q2",
                    "simple_q2")
INSTANCES = {(1, 2), (1, 4), (2, 2), (3, 2), (4, 2)}  # (rows, walk_trees) it builds
MAIN = (289_000, 29, 100, 9)  # analytics_q1 at scale 100
LARGE_D = 4096


@functools.lru_cache(maxsize=None)
def _forest_calls(name):
    """(n, d, T, depth) of every forest_predict call on the workload's kernel
    path at SCALE, on the CPU."""
    calls = []
    real = ops.forest_predict

    def record(x, feat, thresh, leaf):
        n_trees, n_nodes = feat.shape
        calls.append((x.shape[0], x.shape[1], n_trees, (n_nodes + 1).bit_length() - 1))
        return real(x, feat, thresh, leaf)

    w = ALL_WORKLOADS[name](scale=SCALE, device="cpu")
    ops.forest_predict = record
    try:
        execute(kernel_plan(w.plan, w.catalog), w.catalog, device="cpu")
    finally:
        ops.forest_predict = real
    return tuple(calls)


def _check_tiling(n, d, n_trees, depth):
    t = ops.forest_tiling(n, d, n_trees, depth)
    tb = ops.tree_bytes(depth)
    label = f"{(n, d, n_trees, depth)}: {t}"
    assert t.bm % 32 == 0 and t.bm == t.threads // t.tsplit * t.rows, label
    assert t.threads == ops.THREADS and t.threads % (32 * t.tsplit) == 0, label
    # below 256 rows the warps split the trees; above, each thread takes rows
    assert t.tsplit == max(1, ops.THREADS // t.bm), label
    assert (t.rows, t.walk_trees) in INSTANCES and t.walks == t.rows * t.walk_trees, label
    assert t.chunk >= 1 and t.stages in (1, 2), label
    assert t.smem <= ops.SMEM_LIMIT, label
    # the global-read instance exactly where 32 rows do not fit beside a tree
    # (or the 1 KB of the split groups' partial sums)
    assert t.stage_x == (32 * d * 4 + max(tb, 1024) <= ops.SMEM_LIMIT), label
    partials = ops.THREADS * t.rows * 4 if t.tsplit > 1 else 0
    assert t.smem == ((t.bm * d * 4 if t.stage_x else 0)
                      + max(t.stages * t.chunk * tb, partials)), label
    # one buffer only for a forest staged whole, or when two trees do not fit
    if t.stages == 1 and t.chunk < n_trees:
        assert t.chunk == 1 and (t.bm * d * 4 if t.stage_x else 0) + 2 * tb > ops.SMEM_LIMIT
    # two buffers of split trees: a multiple of what the groups walk at once
    if t.stages == 2 and t.tsplit > 1 and t.chunk > t.tsplit * t.walk_trees:
        assert t.chunk % (t.tsplit * t.walk_trees) == 0, label
    return t


@pytest.mark.parametrize("name", sorted(ALL_WORKLOADS))
def test_workload_kernel_paths_call_the_forest(name):
    """The kernel path reaches the forest wrapper in exactly the five
    workloads with a forest, once each."""
    calls = _forest_calls(name)
    assert len(calls) == (1 if name in FOREST_WORKLOADS else 0), calls


@pytest.mark.parametrize("name", FOREST_WORKLOADS)
def test_forest_tiling_workload_forests(name):
    """Every workload forest, at its rows here, at one row, below and at one
    row tile, at scale 1.0 and 100 row counts, and at a large d."""
    (n, d, n_trees, depth), = _forest_calls(name)
    for rows in (n, 1, 31, 32, 2890, MAIN[0]):
        for width in (d, LARGE_D):
            t = _check_tiling(rows, width, n_trees, depth)
            assert t.stage_x == (width == d)


def test_forest_tiling_main_shape():
    """analytics_q1 at scale 100: 377 tiles of 768 rows (2.86 waves on 132
    SMs, where 1024-row tiles make 2.14), 3 rows and 2 trees a thread, 11
    trees a chunk in two buffers beside 89,088 bytes of rows."""
    t = _check_tiling(*MAIN)
    assert (t.bm, t.threads, t.rows, t.walk_trees, t.chunk, t.stages, t.tsplit, t.stage_x,
            t.smem) == (768, 256, 3, 2, 11, 2, 1, True, 224_080)
    assert -(-MAIN[0] // t.bm) == 377


@pytest.mark.parametrize("depth,d_fits", [(9, 1768), (6, 1808), (3, 1808)])
def test_forest_tiling_global_read_boundary(depth, d_fits):
    """The widest d whose 32-row tile fits beside one tree stages its rows;
    one feature more reads them from global memory."""
    assert _check_tiling(1000, d_fits, 10, depth).stage_x
    assert not _check_tiling(1000, d_fits + 1, 10, depth).stage_x


@pytest.mark.parametrize("depth,chunk,stages", [(0, 7, 1), (1, 7, 1), (12, 2, 2),
                                                (13, 1, 2), (14, 1, 1)])
def test_forest_tiling_accepts_every_depth_that_fits(depth, chunk, stages):
    """Depths up to 14 fit one tree in shared memory, as before: small
    forests stage whole, depth 12 two trees a chunk in two buffers, depth 13
    one, depth 14 one tree in one buffer."""
    t = _check_tiling(5000, 29, 7, depth)
    assert (t.chunk, t.stages) == (chunk, stages)


def test_forest_tiling_refuses_a_tree_that_does_not_fit():
    with pytest.raises(ValueError):
        ops.forest_tiling(100, 8, 4, 15)


def test_forest_tiling_small_forest_stages_whole():
    """retail_q2's 160 depth-6 trees (121,600 bytes) stage whole: one chunk,
    one buffer, no barrier between chunks."""
    t = _check_tiling(900, 32, 160, 6)
    assert (t.chunk, t.stages) == (160, 1)


def test_forest_tiling_small_n_splits_trees():
    """analytics_q1 at scale 1.0: 91 tiles of 32 rows, each block's 8 warps
    walking every eighth tree, two at once, 16 trees a chunk in two buffers."""
    t = _check_tiling(2890, 29, 100, 9)
    assert (t.bm, t.tsplit, t.walk_trees, t.chunk, t.stages) == (32, 8, 2, 16, 2)


def test_request_floor():
    """The design floor at the main shape: 9,032 warps of rows x 100 trees x
    9 levels, 3 wavefronts each, over 132 SMs at 1,980 MHz."""
    want = 9032 * 100 * 9 * 3 / (132 * 1.98e9) * 1e3
    assert ops.request_floor_ms(*MAIN[:1], 100, 9, 132, 1.98e9) == pytest.approx(want)
    assert 0.09 < want < 0.095
