"""Tensor parallelism over ``model`` for the port's decoders (GQA, M-RoPE
and MLA) and the Mamba-2 hybrid on a mesh, against the JAX package's
``param_pspecs`` and ``cache_pspecs`` placement under GSPMD, on the CPU.

In process: the serving and training placements (``sharding.serve_specs``,
``sharding.train_specs``) of the eight archs, full and smoke, give every
leaf the block that ``NamedSharding(mesh, param_pspecs)`` gives it on an
``AbstractMesh`` of (2, 4), (2, 2, 2), (1, 8), (16, 16) and (2, 16, 16)
(serving without the ``data`` entries; the experts without theirs, as the
port's training keeps them), and ``init_cache(mesh=)`` every cache entry
the block of ``cache_pspecs``, but for the one documented difference:
where the heads do not divide over ``model`` the port keeps the leaves
split by head whole (and the hybrid's ``conv`` and ``ssm`` states), where
the reference's ``_fit`` cuts them mid-head. ``init_params(mesh=)`` draws
each rank's blocks of the whole init; xLSTM and the encoder-decoder keep
their placement.

In subprocesses, started together: ``python -m repro_torch.testing tp``
on an 8-rank gloo group (every case of ``testing.tp_cases``: the eight
archs' smoke configs in float32 and bfloat16 on (2, 4), (2, 2, 2) and
(1, 8); each rank holds each result to its own one-device run), and this
file run as a script once an arch on 8 forced host devices
(``--xla_force_host_platform_device_count=8``), where the reference's
params are ``device_put`` under ``NamedSharding(mesh, param_pspecs)`` so
that GSPMD runs its tensor-parallel program. Each rank's results are held
to ``jax.jit`` of the reference: ``prefill(mesh=)``'s logits and 3 decode
steps through ``Server(mesh=)`` at ``testing.lm_tol`` (2e-4 in float32,
3e-2 in bfloat16); the loss of ``value_and_grad(mesh=)`` and the rank's
block of every gradient leaf at ``testing.tp_bar`` (2e-4 in float32 of the
leaf's largest |g|, 3e-2 in bfloat16; the MoEs' bfloat16 gradients are not
held, ``testing.tp_holds_grads``); in float32 the serve loop's tokens
exactly on (2, 4), against the reference's server and one device. zamba2
in bfloat16 (``testing.spread_case``), whose reference moves past those
bars between its own mesh program and one device: its logits against the
rank's one-device run at ``lm_tol`` more than the reference's spread, its
gradients at the larger of ``tp_bar`` and that spread. Where the MoE's
experts split over ``model`` the gradient is held to the reference's
one-device gradient: its ``shard_map`` gradient is not its loss's there
(ROADMAP §3).
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCHS as J_ARCHS, get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.launch import serve as jserve
from repro.models import lm as jlm, sharding as jsharding
from repro_torch import testing as T
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import lm, sharding, ssm

SRC = Path(__file__).resolve().parent.parent / "src"
# each subprocess's: eight JAX processes share the CPU with the ranks (about
# 215 s together on 8 idle cores), and a loaded machine runs them slower
RUN_TIMEOUT_S = 900
CASES = T.tp_cases()
SPEC_SHAPES = T.TP_SHAPES + ((16, 16), (2, 16, 16))


def _names(shape) -> tuple:
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


class _Mesh:
    """A stand-in for a (data, model) or (pod, data, model) mesh of the
    port: its shape, and the coordinates of ``rank`` (row-major)."""

    def __init__(self, shape, rank=0):
        self.shape, self.rank = shape, rank
        self.mesh_dim_names = _names(shape)
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)  # the ranks, row-major

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, axis):
        coords = np.unravel_index(self.rank, self.shape)
        return int(coords[self.mesh_dim_names.index(axis)])


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _configs(arch, which):
    return ((j_config(arch), get_config(arch)) if which == "full"
            else (j_smoke(arch), get_smoke_config(arch)))


# ---------------------------------------------------------------------------
# the placement, in process
# ---------------------------------------------------------------------------

def _want_spec(name, p, cfg, shape, train: bool):
    """The reference's spec of a leaf as the port keeps it: its ``model``
    entries (where the heads divide, for the leaves split by head), and in
    training its ``data`` entries but on the experts."""
    heads = cfg.n_heads % shape[-1] == 0
    leaf = name.rsplit("/", 1)[-1]
    out = []
    for e in p:
        if e is None or (e == "model" and name in sharding.tp_leaves(cfg)[0] and not heads):
            out.append(None)
        elif e == "model" or (train and leaf not in sharding.EXPERTS):
            out.append(e)
        else:
            out.append(None)
    return jax.sharding.PartitionSpec(*out)


@pytest.mark.parametrize("shape", SPEC_SHAPES, ids=T.mesh_tag)
@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", T.TP_ARCHS)
def test_blocks_are_param_pspecs_shard_shapes(arch, which, shape):
    """Each leaf's block under ``serve_specs`` and ``train_specs`` is
    ``NamedSharding(mesh, spec).shard_shape`` of the reference's
    ``param_pspecs`` entry as the port keeps it (``_want_spec``); every
    leaf that the reference splits over ``model`` is split, but the leaves
    split by head (``sharding.tp_leaves``) where the heads do not
    divide."""
    jcfg, tcfg = _configs(arch, which)
    amesh = AbstractMesh(shape, _names(shape))
    jspecs = dict(_flat(jsharding.param_pspecs(jcfg, jlm.param_shapes(jcfg), amesh)))
    shapes = dict(_flat(jlm.param_shapes(jcfg)))
    mesh = _Mesh(shape)
    heads, other, _ = sharding.tp_leaves(tcfg)
    for train, fn in ((False, sharding.serve_specs), (True, sharding.train_specs)):
        got = dict(_flat(fn(tcfg, lm.param_shapes(tcfg), mesh)))
        assert set(got) == set(jspecs)
        for k, p in jspecs.items():
            want = _want_spec(k, p, tcfg, shape, train)
            assert sharding.block_shape(shapes[k], got[k], mesh) == tuple(
                NamedSharding(amesh, want).shard_shape(tuple(shapes[k]))), (k, got[k], want)
            if "model" in tuple(p) and k in heads + other:
                kept = k not in heads or tcfg.n_heads % shape[-1] == 0
                assert (("model",) in got[k]) == kept, (k, got[k])


@pytest.mark.parametrize("shape", SPEC_SHAPES, ids=T.mesh_tag)
@pytest.mark.parametrize("batch", [4, 1])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "zamba2-1.2b"])
def test_cache_blocks_are_cache_pspecs_shard_shapes(arch, batch, shape):
    """The cache's blocks under ``serve_cache_specs``: ``init_cache(mesh=)``
    allocates ``NamedSharding(mesh, cache_pspecs).shard_shape`` of every
    entry of the reference's cache (MLA's ``ckv`` and ``kpe`` by rows and
    slots; the hybrid's K/V by rows and slots, its ``conv`` by rows and
    channels, its ``ssm`` by rows and heads), full and smoke, but for the
    hybrid's ``conv`` where the SSM heads do not divide over ``model``
    (the smoke config on (1, 8), 4 heads): whole over ``model``, as its
    Mamba-2 leaves are, where the reference's ``_fit`` cuts the 128
    channels mid-head. ``shard_cache`` cuts the same blocks."""
    mesh, amesh = _Mesh(shape), AbstractMesh(shape, _names(shape))
    for which in ("full", "smoke"):
        jcfg, tcfg = _configs(arch, which)
        jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, batch, 64))
        jspecs = jsharding.cache_pspecs(jcfg, jcache, amesh, batch)
        made = lm.init_cache(tcfg, batch, 64, device="meta", mesh=mesh)
        assert set(made) == set(jcache)
        heads = tcfg.n_heads % shape[-1] == 0
        for k, p in jspecs.items():
            if k == "conv" and not heads:
                p = jax.sharding.PartitionSpec(*(None if e == "model" else e for e in p))
            want = NamedSharding(amesh, p).shard_shape(tuple(jcache[k].shape))
            assert tuple(made[k].shape) == tuple(want), (which, k, made[k].shape, want)
        if which == "smoke":
            whole = lm.init_cache(tcfg, batch, 64, device="cpu")
            cut = sharding.shard_cache(whole, tcfg, mesh)
            assert {k: tuple(v.shape) for k, v in cut.items()} == {
                k: tuple(v.shape) for k, v in made.items()}


@pytest.mark.parametrize("arch", T.TP_ARCHS)
def test_mid_head_cut_is_refused(arch):
    """The one difference from the reference, pinned: on (1, 8) the smoke
    config's 4 heads do not divide, yet the widths of the leaves split by
    head do (``wq`` 64 columns; MLA's ``wq_b`` 96, ``wkv_b`` 128; the
    Mamba-2 layers' 128 channels), which the reference's ``_fit`` splits 8
    ways (half a head a rank); the port keeps those leaves whole (and the
    hybrid's ``conv`` and ``ssm`` states over ``model``) and still splits
    the FFN and the vocab."""
    jcfg, tcfg = _configs(arch, "smoke")
    amesh = AbstractMesh((1, 8), ("data", "model"))
    jspecs = dict(_flat(jsharding.param_pspecs(jcfg, jlm.param_shapes(jcfg), amesh)))
    got = dict(_flat(sharding.serve_specs(tcfg, lm.param_shapes(tcfg), _Mesh((1, 8)))))
    assert tcfg.n_heads % 8
    heads, other, _ = sharding.tp_leaves(tcfg)
    for k in heads:
        assert "model" in tuple(jspecs[k]) and not sharding.spec_axes(got[k]), k
    assert got["embed"][0] == ("model",)
    ffn = [k for k in other if k.endswith(("/w_in", "/sh_in")) and k in got]
    assert bool(ffn) == (tcfg.moe is None or tcfg.moe.n_shared > 0), ffn
    assert all(got[k][-1] == ("model",) for k in ffn), ffn
    if tcfg.kind == "hybrid":
        cache = lm.init_cache(tcfg, 4, 64, device="meta")
        jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, 4, 64))
        jc = jsharding.cache_pspecs(jcfg, jcache, amesh, 4)
        tc = sharding.serve_cache_specs(tcfg, cache, _Mesh((1, 8)), 4)
        assert "model" in tuple(jc["conv"]) and ("model",) not in tc["conv"]
        assert ("model",) not in tc["ssm"] and tc["k"][2] == ("model",)


@pytest.mark.parametrize("arch", sorted(set(J_ARCHS) - set(T.TP_ARCHS)))
def test_other_families_keep_their_placement(arch):
    """xLSTM and the encoder-decoder split only the experts over
    ``model``, as before (they have none), and keep their caches whole."""
    tcfg = get_config(arch)
    assert not sharding.tensor_parallel(tcfg) and sharding.tp_leaves(tcfg) == ((), (), ())
    for shape in ((2, 4), (16, 16)):
        for k, sp in _flat(sharding.serve_specs(tcfg, lm.param_shapes(tcfg), _Mesh(shape))):
            assert not sharding.spec_axes(sp) or k.rsplit("/", 1)[-1] in sharding.EXPERTS, k
        cache = lm.init_cache(tcfg, 4, 64, enc_len=8, device="meta")
        for k, sp in sharding.serve_cache_specs(tcfg, cache, _Mesh(shape), 4).items():
            assert not sharding.spec_axes(sp), k


@pytest.mark.parametrize("shape", T.TP_SHAPES, ids=T.mesh_tag)
def test_init_params_on_a_mesh_draws_the_rank_blocks(shape):
    """``init_params(mesh=)`` on two ranks equals ``shard_params`` of the
    whole init, leaf for leaf; ``shard_params`` keeps a block as it is and
    refuses a leaf of any other shape."""
    cfg = get_smoke_config("qwen2-vl-72b")
    whole = lm.init_params(cfg, seed=4, device="cpu")
    for rank in (0, 7):
        mesh = _Mesh(shape, rank)
        mine = lm.init_params(cfg, seed=4, device="cpu", mesh=mesh)
        cut = sharding.shard_params(whole, cfg, mesh)
        for k, w in _flat(cut):
            assert torch.equal(dict(_flat(mine))[k], w), (shape, rank, k)
        again = sharding.shard_params(cut, cfg, mesh)
        assert again["blocks"]["w_in"] is cut["blocks"]["w_in"]
    bad = dict(whole, embed=whole["embed"][:3])
    with pytest.raises(ValueError, match="embed"):
        sharding.shard_params(bad, cfg, _Mesh(shape))


def test_tp_split_reads_the_placement(monkeypatch):
    """``lm._tp`` follows ``serve_specs``: off a mesh, at one ``model``
    rank and for the other families there is none; on (1, 8) the smoke
    heads stay whole while the FFN and vocab split; on (2, 4) a rank's one
    query head reads one KV head."""
    from repro_torch.core import mesh as mesh_util
    monkeypatch.setattr(mesh_util, "rank_of", lambda mesh, axis="data": 1)
    cfg = get_smoke_config("granite-3-2b")
    assert lm._tp(cfg, None) is None
    assert lm._tp(get_smoke_config("xlstm-1.3b"), _Mesh((2, 4))) is None
    assert lm._tp(get_smoke_config("seamless-m4t-medium"), _Mesh((2, 4))) is None
    assert lm._tp(cfg, _Mesh((8, 1))) is None
    tp = lm._tp(cfg, _Mesh((1, 8)))
    assert (tp.ways, tp.heads, tp.ffn, tp.vocab, tp.ssm) == (8, False, True, True, False)
    tp = lm._tp(cfg, _Mesh((2, 4)))
    assert (tp.ways, tp.rank, tp.heads, tp.ffn, tp.vocab) == (4, 1, True, True, True)
    assert lm._local_kv(cfg, tp) == (1, 0, 1)  # head 1 of 4 reads KV head 0 of 2
    # MLA: heads and the shared experts; the hybrid: the Mamba-2 channels,
    # the shared block's heads and MLP (mid-head on (1, 8): only the MLP)
    mla, hybrid = get_smoke_config("deepseek-v2-236b"), get_smoke_config("zamba2-1.2b")
    tp = lm._tp(mla, _Mesh((2, 4)))
    assert (tp.heads, tp.ffn, tp.vocab, tp.ssm) == (True, True, True, False)
    assert sharding.partial_leaves(mla, _Mesh((2, 4))) == {
        "blocks/wq_a", "blocks/q_ln", "blocks/wkv_a", "blocks/kv_ln"}
    tp = lm._tp(hybrid, _Mesh((2, 4)))
    assert (tp.heads, tp.ffn, tp.vocab, tp.ssm) == (True, True, True, True)
    assert sharding.partial_leaves(hybrid, _Mesh((2, 4))) == {
        "shared_attn/wk", "shared_attn/wv", "mamba/w_bc", "mamba/w_dt", "mamba/dt_bias",
        "mamba/A_log", "mamba/D_skip"}
    tp = lm._tp(hybrid, _Mesh((1, 8)))
    assert (tp.heads, tp.ffn, tp.vocab, tp.ssm) == (False, True, True, False)
    assert sharding.partial_leaves(hybrid, _Mesh((1, 8))) == frozenset()


@pytest.mark.parametrize("shape", T.TP_SHAPES, ids=T.mesh_tag)
def test_block_view_of_another_rank_is_its_own_block(shape):
    """``sharding.block_view(..., rank=r)`` is the block that rank ``r``
    cuts for itself (``place_leaf``): one indexing places the blocks,
    whether each rank cuts its own or one rank holds every rank's."""
    x = torch.arange(8 * 8 * 3).reshape(8, 8, 3)
    mesh = _Mesh(shape)
    spec = (sharding.batch_axes(mesh), ("model",), None)
    axes = sharding.spec_axes(spec)
    for r in range(int(np.prod(shape))):
        own = sharding.place_leaf(x, spec, _Mesh(shape, r))
        assert torch.equal(sharding.block_view(x, spec, mesh, axes, r), own), r


def test_block_refuses_a_leaf_the_compute_does_not_want():
    """No fallback: a rank whose Mamba-2 or MLA leaf is not the block its
    heads want raises; nothing gathers the leaf whole."""
    cfg = get_smoke_config("zamba2-1.2b")
    blk = {k: w[0] for k, w in lm.init_params(cfg, seed=0, device="cpu")["mamba"].items()}
    x = torch.zeros(2, 3, cfg.d_model, dtype=lm._dt(cfg))
    with pytest.raises(ValueError, match="w_in"):
        ssm.mamba2_forward(x, blk, cfg, heads=slice(0, 1))  # whole leaves, one head
    mla = get_smoke_config("deepseek-v2-236b")
    layer = {k: w[0] for k, w in lm.init_params(mla, seed=0, device="cpu")["blocks"].items()}
    tp = lm._TP(None, 4, 0, True, True, True)
    with pytest.raises(ValueError, match="wq_b"):
        lm._mla_prefill(torch.zeros(1, 2, mla.d_model, dtype=lm._dt(mla)), layer, mla,
                        torch.zeros(1, 2, dtype=torch.long), tp)


# ---------------------------------------------------------------------------
# the JAX side: this file as a script on 8 forced host devices
# ---------------------------------------------------------------------------

def _jmesh(shape):
    from jax.sharding import AxisType
    return jax.make_mesh(shape, _names(shape), axis_types=(AxisType.Auto,) * len(shape))


def _placed(tree, cfg, jmesh):
    specs = jsharding.param_pspecs(cfg, jlm.param_shapes(cfg), jmesh)
    return jax.device_put(tree, jax.tree.map(lambda s: NamedSharding(jmesh, s), specs))


def _jax_serve(cfg, params, inp, jmesh, step) -> np.ndarray:
    """The reference's serve loop over the case's requests, its params and
    its jitted decode step (the server's own, compiled once) replaced by
    the case's."""
    srv = jserve.Server(cfg, T.LM_MESH_BATCH, T.LM_MESH_MAX_LEN, mesh=jmesh)
    srv.params, srv.decode_fn = params, step
    reqs = [jserve.Request(rid=i, prompt=p, max_new=inp["max_new"])
            for i, p in enumerate(inp["prompts"])]
    pending, finished = list(reqs), 0
    while finished < len(reqs):
        while pending and srv.free_slots > 0 and srv.admit(pending[0]):
            pending.pop(0)
        finished += srv.step()
    out = np.full((len(reqs), T.LM_MESH_MAX_LEN), -1, np.int32)
    for i, r in enumerate(reqs):
        out[i, :len(r.out)] = r.out
    return out


def _jax_case(case) -> dict:
    cfg = T.lm_mesh_config(case, j_smoke)
    inp = T.tp_inputs(case, cfg)
    dt = getattr(jnp, case["dtype"])
    jmesh = _jmesh(case["shape"])
    whole = jax.tree.map(lambda a: jnp.asarray(a, dt), inp["params"])
    params = _placed(whole, cfg, jmesh)
    label = case["label"]
    step = jax.jit(jlm.make_decode_step(cfg, mesh=jmesh))

    def run(params, mesh, step):
        logits, cache = jax.jit(lambda p, t: jlm.prefill(p, cfg, t, T.LM_MESH_MAX_LEN,
                                                         mesh=mesh))(params, inp["prompt"])
        out = [logits]
        for tok in inp["steps"]:
            lg, cache = step(params, cache, jnp.asarray(tok))
            out.append(lg)
        return np.asarray(jnp.stack(out), np.float32)

    res = {f"{label}/lm": run(params, jmesh, step)}
    if T.spread_case(case):  # the reference on one device
        res[f"{label}/lm{T.ONE_DEVICE}"] = run(whole, None, jax.jit(jlm.make_decode_step(cfg)))
    if case["serve"]:
        res[f"{label}/serve"] = _jax_serve(cfg, params, inp, jmesh, step)
    mesh = jmesh if case["ref"] == "mesh" else None
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, cfg, b, mesh=mesh)))(
        params if mesh is not None else whole, batch)
    res[f"{label}/loss"] = np.asarray(loss, np.float64)
    for path, v in jax.tree_util.tree_leaves_with_path(grads):
        res[f"{label}/grad/" + "/".join(str(p.key) for p in path)] = np.asarray(v, np.float32)
    if T.spread_case(case):  # the reference's own gradient: mesh against one device
        one = jax.jit(jax.grad(lambda p, b: jlm.loss_fn(p, cfg, b)))(whole, batch)
        res[f"{label}/grad-spread"] = np.float64(max(
            float(np.abs(np.asarray(g, np.float32) - np.asarray(o, np.float32)).max())
            / max(float(np.abs(np.asarray(o, np.float32)).max()), 1e-30)
            for g, o in zip(jax.tree.leaves(grads), jax.tree.leaves(one))))
    return res


def jax_side(arch: str, out_dir) -> None:
    """Every case of ``arch`` through the reference; saves
    ``jax_<arch>.npz``."""
    assert jax.device_count() == 8, jax.devices()
    res = {}
    for case in CASES:
        if case["arch"] == arch:
            res.update(_jax_case(case))
    np.savez(Path(out_dir) / f"jax_{arch}.npz", **res)


# ---------------------------------------------------------------------------
# the two sides, in subprocesses
# ---------------------------------------------------------------------------

def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the 8 gloo ranks and one JAX process an arch together;
    returns (the results' directory, the ranks' standard output)."""
    out = tmp_path_factory.mktemp("tp")
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    jenv = _env(JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
        flags + ["--xla_force_host_platform_device_count=8"]))
    procs = {f"jax {a}": subprocess.Popen(
        [sys.executable, __file__, a, str(out)], env=jenv,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for a in T.TP_ARCHS}
    procs["ranks"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.testing", "tp", "--ways", "8",
         "--out", str(out), "--timeout", str(T.GROUP_TIMEOUT_S)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t0, outputs = time.monotonic(), {}
    try:
        for name, p in procs.items():
            outputs[name] = p.communicate(
                timeout=max(1.0, RUN_TIMEOUT_S - (time.monotonic() - t0)))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p in procs.items():
        assert p.returncode == 0, (f"{name} failed\nstdout:\n{outputs[name][0]}\n"
                                   f"stderr:\n{outputs[name][1][-20000:]}")
    want = {}
    for a in T.TP_ARCHS:
        with np.load(out / f"jax_{a}.npz") as z:
            want.update({k: z[k] for k in z.files})
    ranks = []
    for r in range(8):
        with np.load(out / f"rank{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    return outputs["ranks"][0], want, ranks


def test_ranks_hold_each_case_to_one_device(runs):
    """Every case printed its ``OK`` line on rank 0: the logits, the served
    tokens (float32), the loss and the gathered gradients (float32) equal
    the rank's one-device run."""
    stdout, _, _ = runs
    for case in CASES:
        line = next((ln for ln in stdout.splitlines()
                     if ln.startswith(case["label"] + ":")), None)
        assert line is not None and line.endswith(": OK"), case["label"]
        assert ("requests served == one device" in line) == case["serve"], line
    assert stdout.rstrip().endswith("tp suite: OK")
    assert "bf16 all-reduce over 4 model ranks == the float32 sum rounded once" in stdout
    for case in CASES:  # the bf16 MoEs route every token as one device does
        if case["arch"] in T.TP_MOE and case["dtype"] == "bfloat16":
            line = next(ln for ln in stdout.splitlines() if ln.startswith(case["label"] + ":"))
            assert "every token's experts as one device's" in line, line


IDS = [c["label"] for c in CASES]


def _logit_spread(want, label) -> float:
    """The reference's own max |mesh - one device| of a case's logits."""
    return float(np.abs(want[f"{label}/lm"] - want[f"{label}/lm{T.ONE_DEVICE}"]).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prefill_and_decode_match_jax(runs, case):
    """Each rank's prefill logits and 3 steps of ``Server(mesh=)`` against
    the reference's jitted prefill and decode step on placed params, at
    ``lm_tol``; for ``testing.spread_case`` (zamba2 in bfloat16) also the
    rank's logits against its own one-device run at ``testing.spread_bar``
    (``lm_tol`` more than the reference's own mesh-to-one-device spread),
    which the ranks keep for this test, and at that bar against the
    reference where its heads do not divide over ``model``: there the port
    runs its Mamba-2 layers whole, as one device does, and the reference
    cuts them mid-head (``test_mid_head_cut_is_refused``)."""
    _, want, ranks = runs
    key, spread = f"{case['label']}/lm", T.spread_case(case)
    bar = T.spread_bar(case["dtype"], _logit_spread(want, case["label"])) if spread else None
    cfg = T.lm_mesh_config(case, get_smoke_config)
    mid_head = spread and not sharding.heads_split(cfg, _Mesh(case["shape"]))
    tol = bar if mid_head else T.lm_tol(case["dtype"])
    for r, got in enumerate(ranks):
        assert got[key].shape == want[key].shape, (r, got[key].shape)
        np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=tol,
                                   err_msg=f"{key} rank {r}")
        assert (key + T.ONE_DEVICE in got) == spread, (key, r)
        if spread:
            np.testing.assert_allclose(got[key], got[key + T.ONE_DEVICE], rtol=bar, atol=bar,
                                       err_msg=f"{key} rank {r} against its one device")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_loss_and_gradients_match_jax(runs, case):
    """Each rank's loss and its block of every gradient leaf (the training
    placement) against the reference's: JAX's whole leaf cut to the rank's
    block, at ``tp_bar`` of the whole leaf's largest |g| (the MoE in
    bfloat16: the loss, ``testing.tp_holds_grads``; ``testing.spread_case``
    at the larger of ``tp_bar`` and the reference's own mesh-to-one-device
    spread, relative to the leaf's largest |g| as the bar)."""
    _, want, ranks = runs
    label, bar = case["label"], T.tp_bar(case["dtype"])
    gbar = max(bar, float(want[f"{label}/grad-spread"])) if T.spread_case(case) else bar
    cfg = T.lm_mesh_config(case, get_smoke_config)
    specs = dict(_flat(sharding.train_specs(cfg, lm.param_shapes(cfg), _Mesh(case["shape"]))))
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{label}/loss"], want[f"{label}/loss"], rtol=bar,
                                   atol=bar, err_msg=f"{label} rank {r} loss")
        if not T.tp_holds_grads(case):
            continue
        mesh = _Mesh(case["shape"], r)
        for k, spec in specs.items():
            w = want[f"{label}/grad/{k}"]
            blk = sharding.place_leaf(torch.from_numpy(w), spec, mesh).numpy()
            g = got[f"{label}/grad/{k}"]
            assert g.shape == blk.shape, (label, r, k, g.shape, blk.shape)
            np.testing.assert_allclose(g, blk, rtol=gbar,
                                       atol=gbar * max(float(np.abs(w).max()), 1e-30),
                                       err_msg=f"{label} rank {r} {k}")


SPREAD = [c for c in CASES if T.spread_case(c)]


@pytest.mark.parametrize("case", SPREAD, ids=[c["label"] for c in SPREAD])
def test_reference_bf16_hybrid_gradient_moves_past_the_bar(runs, case):
    """Why zamba2's bfloat16 bars against one device take the reference's
    own spread (``testing.spread_case``): the reference's gradient on the
    mesh (its tensor-parallel program) is further from its one-device
    gradient than ``tp_bar`` of the leaf's largest |g| in some leaf, and its
    logits further than ``lm_tol`` from its one device's, so no port could
    meet those bars but by rounding as XLA does, op for op."""
    _, want, _ = runs
    assert T.tp_holds_grads(case)
    assert float(want[f"{case['label']}/grad-spread"]) > T.tp_bar(case["dtype"])
    assert _logit_spread(want, case["label"]) > T.lm_tol(case["dtype"])


SERVED = [c for c in CASES if c["serve"]]


@pytest.mark.parametrize("case", SERVED, ids=[c["label"] for c in SERVED])
def test_serve_loop_matches_jax(runs, case):
    """The float32 serve loop of 6 requests through ``Server(mesh=)``: every
    rank's tokens are the reference server's on the same mesh."""
    _, want, ranks = runs
    key = f"{case['label']}/serve"
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{key} rank {r}")


if __name__ == "__main__":
    jax_side(sys.argv[1], sys.argv[2])
