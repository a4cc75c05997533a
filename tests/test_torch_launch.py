"""The port's launch analysis (``repro_torch.launch.{specs,dryrun,
trace_cost,trace_stats}``) against the JAX package's (``repro.launch``).

In process: ``lm.abstract_params`` has the reference's shapes and dtypes
for all ten configs; ``sharding.to_shape_dtype``'s blocks are
``NamedSharding(AbstractMesh(shape, axes), spec).shard_shape`` of the
reference's specs on (16, 16) and (2, 16, 16); ``trace_cost`` is within
``tests/test_hlo_cost.py``'s 5% of ``hlo_cost.analyze`` on its three
compute cases; a smoke granite prefill traced on ``meta`` tensors counts
exactly the analytic FLOPs of its products; each kernel operator's
shape-only (fake) implementation gives its CPU output's shape, dtype and
strides, passes ``torch.library.opcheck`` and counts its FLOP formula.

In subprocesses, started together: the fake process-group backend
(``torch.testing._internal.distributed.fake_pg``) pinned for what the port
relies on, and ``make_production_mesh`` on fake worlds of 256 and 512
ranks; the reference's ``make_production_mesh`` on 512 forced host
devices; ``python -m repro_torch.launch.dryrun`` for every shape of
granite-3-2b on (16, 16), its decode on (2, 16, 16), granite-moe's
prefill_32k on (16, 16), tensor parallel, and deepseek-v2's prefill_32k and
zamba2's decode_32k on (16, 16), tensor parallel over ``model`` (GB a
rank below the earlier sweep's, when they were not). Each record has
every key that ``benchmarks/roofline.py`` reads, and that module renders
them unchanged.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCHS as J_ARCHS, get_config as j_config
from repro.launch import hlo_cost
from repro.models import lm as jlm, sharding as jsharding
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import trace_cost, trace_stats
from repro_torch.models import lm, sharding

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
RUN_TIMEOUT_S = 240  # each subprocess's
DRYRUN_ARCH = "granite-3-2b"
TP_ARCH = "granite-moe-1b-a400m"
# TP_ARCH's prefill_32k on (16, 16) as the dry run priced it before the batch
# split and tensor parallelism (the whole batch and cache on every rank):
# FLOPs a rank and GB a rank (PERF.md §6)
TP_BEFORE = {"hlo_flops": 3.539634761807936e15, "per_device_total_gb": 77.723}
# MLA's and the hybrid's cells on (16, 16) as the dry run priced them before
# their tensor parallelism (PERF.md §6): FLOPs a rank and GB a rank
MLA_HYBRID_BEFORE = {("deepseek-v2-236b", "prefill_32k"): (1.94e17, 447.0),
                     ("zamba2-1.2b", "decode_32k"): (3.93e11, 8.9)}


class _Mesh:
    """A stand-in for a production mesh of the port: its shape."""

    def __init__(self, shape):
        self.shape, self.mesh_dim_names = shape, MESHES[shape]

    def size(self, dim):
        return self.shape[dim]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# abstract params and their blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_abstract_params_match_reference(arch):
    want = dict(_flat(jlm.abstract_params(j_config(arch))))
    got = dict(_flat(lm.abstract_params(get_config(arch))))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), (k, got[k].dtype, w.dtype)


@pytest.mark.parametrize("shape", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_to_shape_dtype_blocks_are_shard_shapes(arch, shape):
    """Every leaf's block under the reference's ``param_pspecs`` (which the
    port's equal, ``tests/test_torch_lm_mesh.py``) is
    ``NamedSharding.shard_shape`` on an ``AbstractMesh`` of the shape."""
    jcfg, tcfg = j_config(arch), get_config(arch)
    amesh = AbstractMesh(shape, MESHES[shape])
    jspecs = dict(_flat(jsharding.param_pspecs(jcfg, jlm.param_shapes(jcfg), amesh)))
    specs = sharding.param_pspecs(tcfg, lm.param_shapes(tcfg), _Mesh(shape))
    got = dict(_flat(sharding.to_shape_dtype(lm.abstract_params(tcfg), _Mesh(shape), specs)))
    shapes = dict(_flat(jlm.param_shapes(jcfg)))
    for k, spec in jspecs.items():
        want = NamedSharding(amesh, spec).shard_shape(tuple(shapes[k]))
        assert tuple(got[k].shape) == tuple(want), (k, spec)
        assert got[k].device.type == "meta" and got[k].spec == dict(_flat(specs))[k], k


def test_block_shape_rounds_up():
    mesh = _Mesh((2, 16, 16))
    assert sharding.block_shape((100, 33, 5), (("pod", "data"), ("model",)), mesh) == (4, 3, 5)


# ---------------------------------------------------------------------------
# trace_cost against hlo_cost (tests/test_hlo_cost.py's compute cases)
# ---------------------------------------------------------------------------

def _scan(x, w, mm, tanh):
    c = x
    for _ in range(7):
        c = tanh(mm(c, w))
    return c.sum()


def _nested(x, w, mm):
    c = x
    for _ in range(4):
        for _ in range(3):
            c = mm(c, w)
    return c.sum()


def _jax_scan(x, w):
    def body(c, _):
        return jnp.tanh(c @ w), None
    y, _ = jax.lax.scan(body, x, None, length=7)
    return y.sum()


def _jax_nested(x, w):
    def outer(c, _):
        def inner(c2, _):
            return c2 @ w, None
        c2, _ = jax.lax.scan(inner, c, None, length=3)
        return c2, None
    y, _ = jax.lax.scan(outer, x, None, length=4)
    return y.sum()


HLO_CASES = {
    "plain_matmul": (lambda a, b: a @ b, lambda a, b: a @ b,
                     ((64, 128), (128, 256)), "float32"),
    "scan_multiplies_trip_count": (_jax_scan, lambda a, b: _scan(a, b, torch.matmul, torch.tanh),
                                   ((64, 128), (128, 128)), "bfloat16"),
    "nested_scans": (_jax_nested, lambda a, b: _nested(a, b, torch.matmul),
                     ((64, 128), (128, 128)), "float32"),
}


@pytest.mark.parametrize("case", sorted(HLO_CASES))
def test_trace_cost_matches_hlo_cost(case):
    jfn, tfn, shapes, dtype = HLO_CASES[case]
    jargs = [jnp.ones(s, getattr(jnp, dtype)) for s in shapes]
    want = hlo_cost.analyze(jax.jit(jfn).lower(*jargs).compile().as_text())
    targs = [torch.ones(s, dtype=getattr(torch, dtype), device="meta") for s in shapes]
    got = trace_cost.analyze(tfn, *targs)
    assert got["flops"] == pytest.approx(want["flops"], rel=0.05)
    assert got["unknown_loops"] == 0 and got["score_bytes"] == 0
    assert got["collectives"] == {"total": 0}
    assert trace_stats.count_ops(got["ops"], "mm") == {
        "plain_matmul": 1, "scan_multiplies_trip_count": 7, "nested_scans": 12}[case]


def test_prefill_product_flops_are_analytic():
    """A smoke granite prefill on meta tensors: the products' FLOPs are the
    projections, the MLP, attention over the whole (row, key) rectangle
    (the kernel operator's formula) and the last token's logits."""
    cfg = get_smoke_config("granite-3-2b")
    b, s = 2, 24
    params = lm.abstract_params(cfg)
    tokens = torch.zeros((b, s), dtype=torch.int32, device="meta")
    got = trace_cost.analyze(lm.prefill, params, cfg, tokens, 32)
    t, d, hd = b * s, cfg.d_model, cfg.hd
    proj = 2 * t * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    mlp = 2 * t * d * cfg.d_ff * (3 if cfg.act == "swiglu" else 2)
    attn = 2 * b * cfg.n_heads * s * s * (hd + hd)
    want = cfg.n_layers * (proj + mlp + attn) + 2 * b * d * cfg.padded_vocab
    assert got["product_flops"] == want
    assert trace_stats.count_ops(got["ops"], "repro_torch.flash_attention") == cfg.n_layers
    assert got["flops"] > want and got["bytes"] > 0 and got["peak_bytes"] > 0
    logits, cache = got["out"]
    assert logits.device.type == "meta" and tuple(logits.shape) == (b, cfg.padded_vocab)


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-moe-1b-a400m", "zamba2-1.2b",
                                  "seamless-m4t-medium", "qwen2-vl-72b"])
def test_train_step_on_meta_counts_as_on_the_cpu(arch):
    """A smoke train step (2 microbatches, remat) traced on CPU tensors and
    on meta tensors of the same shapes: the same FLOPs, products, bytes and
    peak, so the meta path takes the branches a real run takes (the card's
    ``[dryrun]`` holds the same on the H100)."""
    import dataclasses
    from repro_torch.train.optim import AdamW
    cfg = dataclasses.replace(get_smoke_config(arch), remat=True)
    opt = AdamW()
    step = lm.make_train_step(cfg, opt, microbatches=2)
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (4, 16), generator=g) for k in ("tokens", "labels")}
    if cfg.kind == "encdec":
        batch["enc_embeds"] = torch.randn(4, 7, cfg.d_model, generator=g)
    if cfg.attn == "mrope":
        batch["pos3"] = torch.randint(0, 16, (3, 4, 16), generator=g)
    params = lm.init_params(cfg, 0, device="cpu")
    real = trace_cost.analyze(step, params, opt.init(params), batch)
    meta_params = lm.abstract_params(cfg)
    meta = trace_cost.analyze(step, meta_params, opt.init(meta_params),
                              {k: torch.empty_like(v, device="meta") for k, v in batch.items()})
    for k in ("flops", "product_flops", "bytes", "peak_bytes"):
        assert real[k] == meta[k], (k, real[k], meta[k])
    assert trace_stats.count_ops(meta["ops"], "repro_torch.flash_attention_bwd") == \
        2 * (lm._n_attn(cfg) if cfg.kind == "hybrid" else cfg.n_layers
             + (cfg.n_layers + cfg.enc_layers if cfg.kind == "encdec" else 0))


def test_peak_counts_live_bytes_above_the_arguments():
    x = torch.empty((1024,), device="meta")

    def step(x):
        a = x * 2            # 4 KiB
        b = a + 1            # 4 KiB, both alive
        del a
        c = torch.empty((4096,), device="meta")  # 16 KiB once a is gone
        return b, c

    cost = trace_cost.TraceCost((x,))
    with cost:
        step(x)
    assert cost.peak_bytes == 4096 + 16384


# ---------------------------------------------------------------------------
# the kernel operators' shape-only implementations
# ---------------------------------------------------------------------------

def _op_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(*s, generator=g).to(dt)
    bshd = lambda b, s, h, d: r(b, s, h, d).transpose(1, 2)  # the model's layout
    q, k, v = bshd(2, 9, 4, 16), bshd(2, 9, 2, 16), bshd(2, 9, 2, 16)
    o, lse = torch.ops.repro_torch.flash_attention(q, k, v, True, True)
    x, w, bias = r(6, 5), r(5, 3), r(3)
    feat = torch.randint(0, 5, (4, 7), generator=g, dtype=torch.int32)
    ops = torch.ops.repro_torch
    return {
        "flash_attention/lse": (ops.flash_attention.default, (q, k, v, True, True)),
        "flash_attention/contiguous": (ops.flash_attention.default,
                                       (q.contiguous(), k, v, False, False)),
        "flash_attention_bwd": (ops.flash_attention_bwd.default,
                                (q, k, v, o, lse, r(2, 4, 9, 16), True)),
        "flash_decode": (ops.flash_decode.default,
                         (r(2, 4, 16), r(2, 8, 2, 16), r(2, 8, 2, 16),
                          torch.tensor(5, dtype=torch.int32))),
        "flash_decode_n": (ops.flash_decode_n.default,
                           (r(2, 4, 16), r(2, 8, 2, 16), r(2, 8, 2, 16), 5)),
        "block_matmul": (ops.block_matmul.default, (x, w, 2)),
        "fused_dense": (ops.fused_dense.default, (x, w, bias, "gelu")),
        "forest_predict": (ops.forest_predict.default, (x, feat, r(4, 7), r(4, 8))),
    }


OP_FLOPS = {  # the formulas at the cases' shapes
    "flash_attention/lse": 2 * 2 * 4 * 9 * 9 * 32, "flash_attention/contiguous": 2 * 2 * 4 * 9 * 9 * 32,
    "flash_attention_bwd": 4 * 2 * 4 * 9 * 9 * 32, "flash_decode": 4 * 2 * 4 * 8 * 16,
    "flash_decode_n": 4 * 2 * 4 * 8 * 16, "block_matmul": 2 * 6 * 5 * 3,
    "fused_dense": 2 * 6 * 5 * 3, "forest_predict": 6 * 4 * 4,
}


@pytest.mark.parametrize("name", sorted(OP_FLOPS))
def test_fake_matches_cpu_output(name):
    from torch.utils.flop_counter import FlopCounterMode
    op, args = _op_cases()[name]
    got = op(*[a.to("meta") if isinstance(a, torch.Tensor) else a for a in args])
    with FlopCounterMode(display=False) as flops:
        want = op(*args)
    got, want = (tuple(t) if isinstance(t, (tuple, list)) else (t,) for t in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype, g.stride()) == (w.shape, w.dtype, w.stride()), name
    assert flops.get_total_flops() == OP_FLOPS[name]
    torch.library.opcheck(op, args)


# ---------------------------------------------------------------------------
# fake worlds, the production mesh and the dry run, in subprocesses
# ---------------------------------------------------------------------------

FAKE_PG = r'''
import json, sys, time
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.core import mesh as mu
from repro_torch.launch import mesh as launch_mesh
out = {}
for multi, world in ((False, 256), (True, 512)):
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    pg = dist.group.WORLD
    out[f"backend{world}"] = dist.get_backend(pg)
    out[f"rank{world}"] = dist.get_rank()
    # the fake group keeps no options: group_timeout falls back
    out[f"options{world}"] = repr(pg._get_backend(torch.device("cpu")).options)
    out[f"timeout{world}"] = mu.group_timeout().total_seconds()
    t0 = time.perf_counter()
    m = launch_mesh.make_production_mesh(multi_pod=multi, device="cpu")
    out[f"build_s{world}"] = time.perf_counter() - t0
    out[f"shape{world}"] = [m.size(i) for i in range(m.ndim)]
    out[f"names{world}"] = list(m.mesh_dim_names)
    out[f"local{world}"] = [m.get_local_rank(a) for a in m.mesh_dim_names]
    try:
        mu.make_production_mesh(multi_pod=not multi, device="cpu")
        out[f"wrong{world}"] = "built"
    except ValueError as e:
        out[f"wrong{world}"] = str(e)
    # collectives on meta tensors return at once with their shapes
    x = torch.empty((32, 3), device="meta")
    mu.reset_collective_bytes()
    axes = tuple(m.mesh_dim_names[:-1])
    out[f"gather{world}"] = list(mu.all_gather_rows(x, m, axes).shape)
    out[f"scatter{world}"] = list(mu.reduce_scatter_rows(x, m, axes).shape)
    out[f"sum{world}"] = list(mu.all_reduce_sum(x, m, "model").shape)
    out[f"bytes{world}"] = {f"{k}/{a}": n for (k, a), n in mu.collective_bytes().items()}
    dist.destroy_process_group()
print(json.dumps(out))
'''

JAX_MESH = r'''
import json
import jax
from repro.launch.mesh import make_production_mesh
out = {}
for multi in (False, True):
    m = make_production_mesh(multi_pod=multi)
    out[str(multi)] = [list(m.devices.shape), list(m.axis_names)]
print(json.dumps(out))
'''


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the fake-world probe, the reference's production mesh on 512
    forced host devices and two dry runs together; returns (the records'
    directory, the probe's JSON, the reference's JSON)."""
    out = tmp_path_factory.mktemp("dryrun")
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    jenv = _env(JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
        flags + ["--xla_force_host_platform_device_count=512"]))
    dry = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN_ARCH,
           "--out", str(out)]
    procs = {"fake_pg": ([sys.executable, "-c", FAKE_PG], _env()),
             "jax": ([sys.executable, "-c", JAX_MESH], jenv),
             "single": (dry + ["--mesh", "single"], _env()),
             "multi": (dry + ["--mesh", "multi", "--shape", "decode_32k"], _env()),
             "tp": ([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", TP_ARCH,
                     "--shape", "prefill_32k", "--mesh", "single", "--out", str(out / "tp")],
                    _env())}
    for arch, shape in MLA_HYBRID_BEFORE:
        procs[arch] = ([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                        "--shape", shape, "--mesh", "single", "--out", str(out / "tp")], _env())
    started = {n: subprocess.Popen(c, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True) for n, (c, e) in procs.items()}
    t0, outputs = time.monotonic(), {}
    try:
        for name, p in started.items():
            outputs[name] = p.communicate(
                timeout=max(1.0, RUN_TIMEOUT_S - (time.monotonic() - t0)))
    finally:
        for p in started.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p in started.items():
        assert p.returncode == 0, (f"{name} failed\nstdout:\n{outputs[name][0]}\n"
                                   f"stderr:\n{outputs[name][1][-20000:]}")
    last = lambda name: json.loads(outputs[name][0].strip().splitlines()[-1])
    return out, last("fake_pg"), last("jax")


def test_fake_backend_as_the_port_uses_it(runs):
    """The parts of torch's internal fake backend the dry run relies on:
    ``FakeStore``, a world of 256 or 512 in one process as rank 0, backend
    name ``fake``, no options (so ``group_timeout`` falls back to torch's
    default), subgroups enumerated per mesh axis, and collectives on meta
    tensors that return their result's shape at once."""
    _, fake, _ = runs
    for world in (256, 512):
        assert fake[f"backend{world}"] == "fake" and fake[f"rank{world}"] == 0
        assert fake[f"options{world}"] == "None"
        assert fake[f"timeout{world}"] == 1800.0
        assert fake[f"local{world}"] == [0] * len(fake[f"names{world}"])
        assert "ranks" in fake[f"wrong{world}"]
        ways = world // 16
        assert fake[f"gather{world}"] == [32 * ways, 3]
        assert fake[f"scatter{world}"] == [32 // ways if 32 >= ways else 0, 3]
        assert fake[f"sum{world}"] == [32, 3]
        assert fake[f"build_s{world}"] < 10.0
    # over (pod, data) one axis after the other, each counted under its own
    assert fake["bytes512"]["all-gather/data"] == 32 * 16 * 3 * 4
    assert fake["bytes512"]["all-gather/pod"] == 32 * 32 * 3 * 4
    assert fake["bytes256"]["all-reduce/model"] == 32 * 3 * 4


def test_production_mesh_matches_reference(runs):
    _, fake, ref = runs
    for multi, world in ((False, 256), (True, 512)):
        shape, names = ref[str(multi)]
        assert fake[f"shape{world}"] == shape and fake[f"names{world}"] == names


def test_launch_mesh_reexports_the_builders():
    from repro_torch.core import mesh as core_mesh
    from repro_torch.launch import mesh as launch_mesh
    assert launch_mesh.make_production_mesh is core_mesh.make_production_mesh
    assert launch_mesh.make_host_mesh is core_mesh.make_host_mesh


# every key benchmarks/roofline.py reads of an ``ok`` record
ROOFLINE_KEYS = ("arch", "shape", "mesh", "status", "roofline", "bottleneck",
                 "useful_ratio", "roofline_fraction", "model_flops", "memory")


def _record(out, shape, mesh="single"):
    with open(out / f"{DRYRUN_ARCH}_{shape}_{mesh}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_run_cell_reaches_ok(runs, shape):
    """One full-size cell of each kind on (16, 16): the reference's keys,
    H100 rates, the memory a rank from the meta blocks."""
    out, _, _ = runs
    rec = _record(out, shape)
    assert rec["status"] == "ok", rec.get("traceback")
    for k in ROOFLINE_KEYS + ("hlo_flops", "hlo_bytes", "score_bytes", "collectives",
                              "roofline_flash", "device", "rates"):
        assert k in rec, k
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert {"argument_bytes", "temp_bytes", "per_device_total_gb"} <= set(rec["memory"])
    assert rec["device"] == "H100 SXM" and rec["rates"]["peak_flops"] == 989e12
    assert rec["hlo_flops"] >= rec["product_flops"] > 0 and rec["score_bytes"] == 0
    assert rec["roofline_flash"] == rec["roofline"]
    assert rec["chips"] == 256 and rec["trace_s"] < 60
    # the decode step's attention merges over model and gathers rows over data
    if shape == "decode_32k":
        assert set(rec["collectives_by_axis"]) == {"data", "model"}


def test_dryrun_records_read_by_roofline(runs):
    """``benchmarks/roofline.py`` renders the port's records unchanged; the
    long-context cell of a full-attention arch is skipped with its note."""
    out, _, _ = runs
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import roofline
    finally:
        sys.path.remove(str(ROOT))
    lines = roofline.run(str(out))
    assert len(lines) == 5 and sum("skipped" in ln for ln in lines) == 1
    assert not any("error=" in ln for ln in lines)
    table = roofline.markdown_table(str(out), mesh="16x16")
    assert table.count(f"| {DRYRUN_ARCH} |") == 4
    assert "skipped" in _record(out, "long_500k")["long_context_note"]


def test_multi_pod_decode_reduces_over_pod(runs):
    """On (2, 16, 16) the decode step's rows split over pod and data: its
    gathers cross both axes."""
    out, _, _ = runs
    rec = _record(out, "decode_32k", "multi")
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16" and rec["chips"] == 512
    assert set(rec["collectives_by_axis"]) == {"pod", "data", "model"}
    single = _record(out, "decode_32k")
    assert rec["memory"]["argument_bytes"] < single["memory"]["argument_bytes"]


def test_tensor_parallel_prefill_falls_as_predicted(runs):
    """granite-moe's prefill_32k on (16, 16): with each rank on its 2 rows
    of the batch, the attention and vocabulary split over 16 ``model``
    ranks and only its block of the cache allocated, its FLOPs a rank fall
    to at most 1/16 of ``TP_BEFORE``'s (the batch split alone) and its GB a
    rank below it; the activations' sums run over ``model``."""
    out, _, _ = runs
    with open(out / "tp" / f"{TP_ARCH}_prefill_32k_single.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["hlo_flops"] <= TP_BEFORE["hlo_flops"] / 16, rec["hlo_flops"]
    assert rec["memory"]["per_device_total_gb"] < TP_BEFORE["per_device_total_gb"]
    assert rec["collectives_by_axis"]["model"] > 0



@pytest.mark.parametrize("arch,shape", sorted(MLA_HYBRID_BEFORE))
def test_mla_and_hybrid_cells_fall_with_tensor_parallelism(runs, arch, shape):
    """deepseek-v2's prefill_32k and zamba2's decode_32k on (16, 16), now
    tensor parallel over ``model``: every key ``benchmarks/roofline.py``
    reads, and GB a rank below ``MLA_HYBRID_BEFORE``'s (and deepseek-v2's
    prefill below 80 GB, at most 1/16 of its FLOPs a rank: its rows split
    over ``data`` and its heads over ``model``); the activations' sums and
    the decode's merges run over ``model``."""
    out, _, _ = runs
    with open(out / "tp" / f"{arch}_{shape}_single.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok", rec.get("traceback")
    for k in ROOFLINE_KEYS + ("hlo_flops", "hlo_bytes", "collectives", "collectives_by_axis"):
        assert k in rec, k
    flops, gb = MLA_HYBRID_BEFORE[(arch, shape)]
    assert rec["memory"]["per_device_total_gb"] < gb, rec["memory"]
    assert rec["hlo_flops"] <= flops, rec["hlo_flops"]
    assert rec["collectives_by_axis"]["model"] > 0
    if shape == "prefill_32k":
        assert rec["memory"]["per_device_total_gb"] < 80
        assert rec["hlo_flops"] <= flops / 16, rec["hlo_flops"]
