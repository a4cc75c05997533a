"""Multi-pod dry run: trace every (arch x shape x mesh) cell as rank 0 of
the production mesh on a fake world of 256 or 512 ranks, on ``meta``
tensors. The port of ``repro.launch.dryrun``; nothing is allocated on any
device and no card is needed.

The reference lowers and compiles each cell with 512 placeholder host
devices (``XLA_FLAGS`` set before JAX starts). Here ``main`` starts, for
each mesh, a process of its own (all at once) that initialises torch's fake
process-group backend (``torch.testing._internal.distributed.fake_pg``)
as rank 0 of a world of 256 or 512, builds the mesh
(``core.mesh.make_production_mesh``) and runs each cell's step once under
``trace_cost.TraceCost``: the train step with its backward and remat, the
prefill, one decode step. The fake group's collectives move nothing and
return at once; ``core.mesh`` counts their bytes. For each cell the record
keeps the reference's keys (``benchmarks/roofline.py`` reads them):

  - status (ok / skipped / error), the trace's wall time and the mesh's
    (``make_production_mesh`` enumerating each axis's subgroups);
  - ``hlo_flops`` / ``hlo_bytes``: ``trace_cost``'s FLOPs and bytes of the
    rank's eager ops (the names are the reference's; no HLO is involved);
  - ``collectives``: bytes by kind, and ``collectives_by_axis``;
  - ``memory``: the rank's argument bytes (its meta blocks), the traced
    peak above them (``temp_bytes``) and their sum in GB;
  - MODEL_FLOPS = 6·N(_active)·D (2·N·D serving) and the useful ratio;
  - the three roofline terms at H100 SXM rates, the bottleneck and the
    roofline fraction; ``roofline_flash`` equals ``roofline``
    (``score_bytes`` is 0: the port's attention kernels keep the scores on
    chip).

Rates, per GPU:
  - 989e12 FLOP/s dense bf16 on the tensor cores and 3.35e12 B/s of HBM3:
    NVIDIA's H100 SXM data sheet (the rates of PERF.md §6);
  - 450e9 B/s a direction over NVLink 4 within one 8-GPU node (900 GB/s
    bidirectional, the same data sheet);
  - 50e9 B/s across nodes: NDR InfiniBand at 400 Gb/s, one ConnectX-7 a
    GPU, as in NVIDIA's DGX H100 user guide.
Ranks fill nodes of 8 in order, so a mesh axis whose groups span at most
8 consecutive ranks is priced at NVLink's rate, any other at
InfiniBand's; each axis's bytes go at its own rate.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import mesh as mesh_util
from repro_torch.launch import trace_cost, trace_stats
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import SHAPES, build_cell, long_context_applicability

DEVICE = "H100 SXM"
PEAK_FLOPS = 989e12     # dense bf16 FLOP/s a GPU (H100 SXM data sheet)
HBM_BW = 3.35e12        # HBM3 bytes/s a GPU (H100 SXM data sheet)
NVLINK_BW = 450e9       # NVLink 4 bytes/s a direction a GPU, within a node
IB_BW = 400e9 / 8       # NDR InfiniBand, 400 Gb/s a GPU, across nodes
GPUS_PER_NODE = 8


def input_specs(arch: str, shape_name: str, mesh):
    """Public helper (assignment API): this rank's meta tensors for every
    model input of the given cell."""
    return build_cell(get_config(arch), shape_name, mesh).args


def axis_rates(mesh) -> dict:
    """Bytes/s of each mesh axis: NVLink where every group of the axis lies
    within one node of ``GPUS_PER_NODE`` consecutive ranks, else
    InfiniBand."""
    names = mesh.mesh_dim_names
    shape = [mesh.size(i) for i in range(len(names))]
    out = {}
    for i, a in enumerate(names):
        span = math.prod(shape[i:])  # consecutive ranks a group ranges over
        out[a] = NVLINK_BW if span <= GPUS_PER_NODE and GPUS_PER_NODE % span == 0 else IB_BW
    return out


def _tree_bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _tokens(shape_name: str) -> float:
    info = SHAPES[shape_name]
    if info["kind"] in ("train", "prefill"):
        return info["seq"] * info["batch"]
    return info["batch"]  # decode: one new token per sequence


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """One cell's record, traced as this rank of the production mesh over
    the initialised (real or fake) world of 256 or 512 ranks."""
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16", "device": DEVICE,
           "rates": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "nvlink_bw": NVLINK_BW,
                     "ib_bw": IB_BW}}
    if shape_name == "long_500k":
        ok, why = long_context_applicability(cfg)
        rec["long_context_note"] = why
        if not ok:
            rec["status"] = "skipped"
            return rec
    try:
        t0 = time.perf_counter()
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        mesh_s = time.perf_counter() - t0  # its subgroups enumerated, one axis at a time
        n_chips = mesh.size()
        cell = build_cell(cfg, shape_name, mesh)
        t0 = time.perf_counter()
        with trace_cost.TraceCost(cell.args) as cost:
            cell.fn(*cell.args)
        rec.update(status="ok", trace_s=round(time.perf_counter() - t0, 1),
                   mesh_s=round(mesh_s, 4), chips=n_chips, descr=cell.static_descr)
        flops, bytes_acc = float(cost.flops), float(cost.bytes)
        rec["hlo_flops"] = flops
        rec["product_flops"] = float(cost.product_flops)
        rec["hlo_bytes"] = bytes_acc
        rec["score_bytes"] = cost.score_bytes
        rec["unknown_loops"] = 0
        args = _tree_bytes(cell.args)
        rec["memory"] = {"argument_bytes": args, "temp_bytes": cost.peak_bytes,
                         "per_device_total_gb": round((args + cost.peak_bytes) / 1e9, 3)}
        rec["collectives"] = {k: float(v) for k, v in
                              trace_stats.collective_bytes(cost.collectives).items()}
        by_axis = trace_stats.by_axis(cost.collectives)
        rec["collectives_by_axis"] = {a: float(v) for a, v in by_axis.items()}
        rates = axis_rates(mesh)
        rec["axis_rates"] = rates
        n_active = cfg.active_param_count()
        mult = 6.0 if shape_name == "train_4k" else 2.0
        model_flops = mult * n_active * _tokens(shape_name)  # global useful FLOPs
        per_dev_model = model_flops / n_chips
        rec["model_flops"] = model_flops
        rec["useful_ratio"] = round(per_dev_model / flops, 4) if flops else None
        rec["roofline"] = {
            "compute_s": flops / PEAK_FLOPS,
            "memory_s": bytes_acc / HBM_BW,
            "collective_s": sum(v / rates[a] for a, v in by_axis.items()),
        }
        rt = rec["roofline"]
        rec["bottleneck"] = max(rt, key=rt.get)
        rec["roofline_fraction"] = round(
            (per_dev_model / PEAK_FLOPS) / max(max(rt.values()), 1e-30), 4)
        # the scores never leave the chip: the flash roofline is the roofline
        rec["roofline_flash"] = dict(rt)
        rec["bottleneck_flash"] = rec["bottleneck"]
        rec["roofline_fraction_flash"] = rec["roofline_fraction"]
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    return rec


def start_fake_world(world: int) -> None:
    """This process as rank 0 of a fake world of ``world`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _sweep(multi_pod: bool, cells: list, out: str) -> None:
    """The cells of one mesh, in a process whose world is that mesh's."""
    world = math.prod(mesh_util.PRODUCTION_SHAPES[multi_pod][0])
    start_fake_world(world)
    torch.set_num_threads(1)
    for arch, shape in cells:
        tag = f"{arch}_{shape}_{'multi' if multi_pod else 'single'}"
        rec = run_cell(arch, shape, multi_pod)
        with open(os.path.join(out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=2)
        status = rec.get("status")
        extra = ""
        if status == "ok":
            extra = (f" flops={rec['hlo_flops']:.3e}"
                     f" coll={rec['collectives']['total']:.3e}B"
                     f" bottleneck={rec['bottleneck']}"
                     f" frac={rec['roofline_fraction']}"
                     f" mem/dev={rec['memory']['per_device_total_gb']}GB"
                     f" trace={rec['trace_s']}s mesh={rec['mesh_s']}s")
        elif status == "error":
            extra = " " + rec["error"][:200]
        print(f"[{status:7s}] {tag}{extra}", flush=True)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.all or args.arch is None else [args.arch]
    shapes = sorted(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    cells = [(a, s) for a in archs for s in shapes]
    # one process a mesh, all started together: a world's size is fixed
    # when its group starts
    ctx = multiprocessing.get_context("spawn")
    t0 = time.time()
    procs = {mp: ctx.Process(target=_sweep, args=(mp, cells, args.out)) for mp in meshes}
    for proc in procs.values():
        proc.start()
    failed = []
    for mp, proc in procs.items():
        proc.join()
        if proc.exitcode != 0:
            failed.append(f"the {'multi' if mp else 'single'}-pod sweep exited {proc.exitcode}")
    if failed:
        print("; ".join(failed))
        return 1
    print(f"dryrun: {len(cells) * len(meshes)} records in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
