"""Wrapper of the decision_forest kernel (``csrc/decision_forest.cu``).

Replaces ``src/repro/kernels/decision_forest/ops.py::forest_predict`` and
the Pallas kernel behind it (``kernel.py::forest_pallas``). No one-hot
feature selectors are built here: the kernel gathers features directly. On
a CPU tensor it runs the plain version (``ref.py``); on a CUDA tensor it
launches the kernel instance that ``forest_tiling`` picks.

The call goes through the custom operator ``repro_torch::forest_predict``,
so that it keeps running inside a CUDA-graph capture and under
``torch.func.vmap``, whose batching rule folds the batch axis into the rows
and launches the kernel once over all of them (a batched forest raises).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.decision_forest import ref

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
N_SM = 132  # streaming multiprocessors of an H100 SXM
THREADS = 256  # threads of a block
ROW_TILES = (32, 64, 128, 256, 512, 768, 1024)  # BM: 256 threads x 1-4 rows above 256
launches = 0  # kernel launches since the last reset


def tree_bytes(depth: int) -> int:
    """Shared bytes of one staged tree: 8-byte node records {feat, thresh}
    and 4-byte leaves."""
    return 8 * (2 ** depth - 1) + 4 * 2 ** depth


@dataclasses.dataclass(frozen=True)
class ForestTiling:
    bm: int  # rows of a block
    threads: int  # threads of a block
    rows: int  # rows each thread walks (bm = threads / tsplit * rows)
    walk_trees: int  # trees each thread walks at once, per row
    chunk: int  # trees staged per chunk
    stages: int  # tree buffers: 2 lets the next chunk load while one is walked
    tsplit: int  # groups of warps that share the rows and split the trees
    stage_x: bool  # rows staged in shared memory; else read from global memory
    smem: int  # dynamic shared-memory bytes of a block

    @property
    def walks(self) -> int:
        """Walks each thread keeps in flight."""
        return self.rows * self.walk_trees


def forest_tiling(n: int, d: int, n_trees: int, depth: int,
                  n_sm: int = N_SM) -> ForestTiling:
    """The kernel's tiling for ``n`` rows of ``d`` features and ``n_trees``
    trees of depth ``depth``.

    The rows of a block are staged feature-major in shared memory when 32 of
    them fit beside one tree (and beside the 1 KB of partial sums of a block
    whose warps split the trees); otherwise the global-read instance runs. BM is
    the tile whose waves cost least, counting a block's work as its rows plus
    the staging of its trees (2^D / D rows' worth of walking: ~3 words a node
    copied and fixed up against D lookups a row). The trees fill what is
    left: the whole forest when it fits, else two buffers of as many trees
    as fit, else one tree at a time. A block has 256 threads; below 256
    rows its warps split each chunk's trees (``tsplit`` groups, each walking
    two trees at once, a chunk of two buffers cut to a multiple of what the
    groups walk at once) and add their sums at the end.
    """
    tb = tree_bytes(depth)
    if tb > SMEM_LIMIT:
        raise ValueError(f"forest_predict: a depth-{depth} tree needs {tb} bytes "
                         "of shared memory")
    beside = max(tb, THREADS * 4)  # a tree, or the split groups' partial sums
    stage_x = 32 * d * 4 + beside <= SMEM_LIMIT
    staging = 2 ** depth / max(depth, 1)
    best = None
    for bm in ROW_TILES:
        if stage_x and bm * d * 4 + beside > SMEM_LIMIT:
            break
        cost = common.cdiv(common.cdiv(max(n, 1), bm), n_sm) * (bm + staging)
        if best is None or cost <= best[0]:
            best = (cost, bm)
    bm = best[1]
    row_threads = min(bm, THREADS)
    rows, tsplit = bm // row_threads, THREADS // row_threads
    walk_trees = 4 if rows == 1 and tsplit == 1 else 2
    x_bytes = bm * d * 4 if stage_x else 0
    room = SMEM_LIMIT - x_bytes
    if n_trees * tb <= room:
        chunk, stages = max(n_trees, 1), 1
    elif room // (2 * tb) >= 1:
        chunk, stages = room // (2 * tb), 2
        group = tsplit * walk_trees  # trees the groups walk at once
        if tsplit > 1 and chunk > group:
            chunk -= chunk % group
    else:
        chunk, stages = 1, 1
    trees = stages * chunk * tb
    partials = THREADS * rows * 4 if tsplit > 1 else 0
    return ForestTiling(bm=bm, threads=THREADS, rows=rows, walk_trees=walk_trees,
                        chunk=chunk, stages=stages, tsplit=tsplit, stage_x=stage_x,
                        smem=x_bytes + max(trees, partials))


WAVEFRONTS_PER_STEP = 3  # a warp's level step: its 32 row values, its 8-byte records


def request_floor_ms(n: int, n_trees: int, depth: int, n_sm: int,
                     clock_hz: float) -> float:
    """The shared-memory request floor of this design: n*T*D lookups, 32 to a
    warp step at WAVEFRONTS_PER_STEP conflict-free wavefronts, over the SMs'
    one wavefront a clock."""
    steps = common.cdiv(n, 32) * n_trees * depth
    return steps * WAVEFRONTS_PER_STEP / (n_sm * clock_hz) * 1e3


def _check(x, feat, thresh, leaf) -> int:
    """Validates the operands; returns the depth."""
    n_trees, n_nodes = feat.shape
    depth = (n_nodes + 1).bit_length() - 1
    if (x.ndim != 2 or n_nodes != 2 ** depth - 1
            or tuple(thresh.shape) != (n_trees, n_nodes)
            or tuple(leaf.shape) != (n_trees, 2 ** depth)):
        raise ValueError(f"forest_predict: shapes x{tuple(x.shape)} "
                         f"feat{tuple(feat.shape)} thresh{tuple(thresh.shape)} "
                         f"leaf{tuple(leaf.shape)}")
    if (feat.dtype != torch.int32 or thresh.dtype != torch.float32
            or leaf.dtype != torch.float32):
        raise TypeError(f"forest_predict: dtypes {feat.dtype}, {thresh.dtype}, "
                        f"{leaf.dtype}")
    return depth


def launch(xf: torch.Tensor, feat: torch.Tensor, thresh: torch.Tensor,
           leaf: torch.Tensor, tiling: ForestTiling) -> torch.Tensor:
    """Runs the kernel instance of ``tiling`` on float32 CUDA operands."""
    global launches
    common.check_cuda_operands("forest_predict", xf, feat, thresh, leaf)
    n, d = xf.shape
    n_trees, n_nodes = feat.shape
    out = torch.empty((n,), dtype=torch.float32, device=xf.device)
    if n == 0:
        return out
    t = tiling
    with torch.cuda.device(xf.device):
        rc = build.entry("forest_predict")(
            ctypes.c_void_p(xf.data_ptr()), ctypes.c_void_p(feat.data_ptr()),
            ctypes.c_void_p(thresh.data_ptr()), ctypes.c_void_p(leaf.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), n, d, n_trees,
            (n_nodes + 1).bit_length() - 1, t.threads, t.rows, t.walk_trees,
            t.chunk, t.stages, t.tsplit, int(t.stage_x), t.smem,
            ctypes.c_void_p(common.stream_ptr(xf)))
    if rc != 0:
        raise RuntimeError(f"forest_predict: launch failed, CUDA error {rc}")
    launches += 1
    return out


def forest_predict(x: torch.Tensor, feat: torch.Tensor, thresh: torch.Tensor,
                   leaf: torch.Tensor) -> torch.Tensor:
    _check(x, feat, thresh, leaf)
    return _forest_op(x.float(), feat, thresh, leaf).to(x.dtype)


@torch.library.custom_op("repro_torch::forest_predict", mutates_args=(),
                         device_types="cpu")
def _forest_op(x: torch.Tensor, feat: torch.Tensor, thresh: torch.Tensor,
               leaf: torch.Tensor) -> torch.Tensor:
    return ref.forest_predict(x, feat, thresh, leaf)


@_forest_op.register_kernel("cuda")
def _forest_cuda(x: torch.Tensor, feat: torch.Tensor, thresh: torch.Tensor,
                 leaf: torch.Tensor) -> torch.Tensor:
    n, d = x.shape
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    depth = (feat.shape[1] + 1).bit_length() - 1
    return launch(x, feat, thresh, leaf, forest_tiling(n, d, feat.shape[0], depth, n_sm))


@_forest_op.register_vmap
def _forest_vmap(info, in_dims, x, feat, thresh, leaf):
    x_dim, *forest_dims = in_dims
    for dim in forest_dims:
        common.unbatched_param("forest_predict", dim)
    rows, b, m = common.fold_rows(x, x_dim)
    return common.unfold_rows(_forest_op(rows, feat, thresh, leaf), b, m), 0
