"""The port's LM on a (data, model) mesh against the JAX package's
``shard_map`` paths, on the CPU.

In process, with stand-in meshes of the same shape in each package (JAX's
``AbstractMesh``): ``sharding.param_pspecs`` and ``cache_pspecs`` equal the
reference's ``PartitionSpec``s leaf by leaf (the port's convention: one
entry a dimension, a tuple of axis names or None) for all ten configs, full
and smoke, on (2, 4), (1, 8) and (2, 2, 2) meshes; the serving placement
cuts the experts, the GQA decoders' tensor-parallel leaves and the
attention cache only, and refuses slots that do not divide over ``model``
(the tensor-parallel paths themselves: ``tests/test_torch_tp.py``).

In subprocesses, started together: ``python -m repro_torch.testing
lm-mesh`` on an 8-rank gloo group, and this file run as a script (the JAX
side) once for each mesh shape on 8 forced host devices
(``--xla_force_host_platform_device_count=8``). Both take the cases of
``repro_torch.testing.lm_mesh_cases`` with the same seeded inputs:
``sharded_decode_attention`` (a slice holding no valid slot, a batch that
does not divide over ``data``), ``moe_block`` with its experts split (at 4
and 300 tokens a rank, past the dropless 256) and whole (4 experts on 8
model ranks), MLA's sharded latent attention, ``prefill(mesh=)`` and 3
decode steps through ``Server(mesh=)`` for granite-3-2b, granite-moe,
deepseek-v2 and zamba2 (and granite-3-2b writing the last slot twice), and
the serve loop of 6 requests (the reference's params placed under
``param_pspecs`` for the LM cases, so that GSPMD runs its tensor-parallel
program, as the port's mesh path is); on a (2, 2, 2) (pod, data, model) mesh,
whose batch rows split over pod and data, ``prefill(mesh=)`` and 3 decode
steps of granite-3-2b (float32 and bfloat16) and granite-moe (float32). Each rank's results are held to JAX's
``jax.jit`` of the reference under ``shard_map`` at the port's LM bars:
2e-4 in float32 and 3e-2 in bfloat16 (``tests/test_torch_lm_families.py``'s
for these families); the served tokens exactly. The ranks also hold each
result to their own one-device run at the same bars (one ``OK`` line a
case; zamba2 in bfloat16, ``testing.spread_case``, here at ``lm_tol``
more than the reference's own mesh-to-one-device spread: its
tensor-parallel program rounds its partial sums otherwise, as the port's
does), and ``_gather_fsdp`` over ``data`` gives the whole weights back.
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
from repro.models import layers as jL, lm as jlm, sharding as jsharding
from repro_torch import testing as T
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import lm, sharding

SRC = Path(__file__).resolve().parent.parent / "src"
CLAMPED, ONE_DEVICE = "/clamped", T.ONE_DEVICE
SHAPES = T.LM_MESH_SHAPES
# each subprocess's, above the group's: run beside the tensor-parallel
# suite's sixteen processes on 8 cores, the JAX side took over 300 s
RUN_TIMEOUT_S = 900


def _names(shape) -> tuple:
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


class _Mesh:
    """A stand-in for a (data, model) or (pod, data, model) mesh of the
    port: its shape."""

    def __init__(self, shape):
        self.shape = shape
        self.mesh_dim_names = _names(shape)

    def size(self, dim):
        return self.shape[dim]


def _jspec(p) -> tuple:
    """A JAX ``PartitionSpec`` in the port's convention."""
    return tuple(None if e is None else (e,) if isinstance(e, str) else tuple(e) for e in p)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _configs(arch, which):
    return ((j_config(arch), get_config(arch)) if which == "full"
            else (j_smoke(arch), get_smoke_config(arch)))


# ---------------------------------------------------------------------------
# specs, in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_param_pspecs_match_jax(arch, which, shape):
    jcfg, tcfg = _configs(arch, which)
    want = dict(_flat(jsharding.param_pspecs(jcfg, jlm.param_shapes(jcfg),
                                             AbstractMesh(shape, _names(shape)))))
    got = dict(_flat(sharding.param_pspecs(tcfg, lm.param_shapes(tcfg), _Mesh(shape))))
    assert set(got) == set(want)
    for k, p in want.items():
        assert got[k] == _jspec(p), (k, got[k], p)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("batch", [4, 1])
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_cache_pspecs_match_jax(arch, batch, shape):
    """Full configs' caches (shapes only: the port's on the meta device)."""
    jcfg, tcfg = _configs(arch, "full")
    jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, batch, 64, enc_len=8))
    want = jsharding.cache_pspecs(jcfg, jcache, AbstractMesh(shape, _names(shape)), batch)
    cache = lm.init_cache(tcfg, batch, 64, enc_len=8, device="meta")
    got = sharding.cache_pspecs(tcfg, cache, _Mesh(shape), batch)
    assert set(got) == set(want)
    for k, p in want.items():
        assert got[k] == _jspec(p), (k, got[k], p)
        assert tuple(cache[k].shape) == tuple(jcache[k].shape), k


def test_gather_fsdp_is_identity_off_a_mesh_or_fsdp():
    cfg = get_smoke_config("deepseek-67b")
    blk, specs = {"wq": torch.zeros(2, 2)}, {"wq": (("data",), None)}
    assert lm._gather_fsdp(blk, cfg, None, specs) is blk
    assert not cfg.fsdp and lm._gather_fsdp(blk, cfg, _Mesh((2, 4)), specs) is blk


def test_train_use_gathers_nothing_without_fsdp():
    """A training pass of a config without FSDP hands each layer its leaves
    as they are, before it reads any spec."""
    cfg = get_smoke_config("deepseek-67b")
    blk = {"wq": torch.zeros(2, 2)}
    train = lm._Train(mesh=_Mesh((2, 4)), split=True, specs={})
    assert not cfg.fsdp and train.use(blk, cfg, "blocks") is blk


@pytest.mark.parametrize("shape,split", [((2, 4), True), ((1, 8), False)])
def test_placement_cuts_only_experts_and_attention_cache(shape, split):
    """Off a process group the cut is checked through its shapes. The
    serving placement cuts, of the params, only the experts (E / model of
    them where the expert count divides) and, in the GQA decoders, the
    tensor-parallel leaves over ``model`` (``wq`` and ``wo`` where the
    heads divide, the FFN and the vocab); every other leaf (``wk``, ``wv``,
    the router, the norms) is the same tensor. Of the cache it cuts only
    the attention rows: ``init_cache(mesh=)`` allocates the block that
    ``shard_cache`` cuts, both refuse slots that do not divide over
    ``model``, and the encoder-decoder's and xLSTM's caches stay whole."""
    class Ranked(_Mesh):
        def get_local_rank(self, axis):
            return 0

    mesh = Ranked(shape)
    ways = shape[-1]
    heads = 4 % ways == 0  # the smoke configs' 4 query heads
    for arch in ("granite-moe-1b-a400m", "granite-3-2b"):
        cfg = get_smoke_config(arch)
        params = lm.init_params(cfg, seed=0, device="cpu")
        placed = sharding.shard_params(params, cfg, mesh)
        for k, w in params["blocks"].items():
            got = placed["blocks"][k].shape
            if k in sharding.EXPERTS:
                e = cfg.moe.n_experts
                assert got[1] == (e // ways if split else e), k
            elif k in ("wq", "w_gate", "w_in"):
                assert got[-1] == w.shape[-1] // (ways if heads or k != "wq" else 1), k
            elif k in ("wo", "w_out"):
                assert got[-2] == w.shape[-2] // (ways if heads or k != "wo" else 1), k
            else:
                assert placed["blocks"][k] is w, k
        assert placed["embed"].shape[0] == cfg.padded_vocab // ways
        assert placed["final_norm"] is params["final_norm"]
        assert sharding.sharded_experts(cfg, mesh) is (split and cfg.moe is not None)
    cache = lm.init_cache(cfg, 4, 64, device="cpu")
    local = sharding.shard_cache(cache, cfg, mesh)
    assert tuple(local["k"].shape) == (cfg.n_layers, 4 // shape[0], 64 // shape[1],
                                       cfg.n_kv_heads, cfg.hd)
    assert local["len"] is cache["len"]
    made = lm.init_cache(cfg, 4, 64, device="cpu", mesh=mesh)
    assert {k: tuple(v.shape) for k, v in made.items()} == {
        k: tuple(v.shape) for k, v in local.items()}
    for bad in (lambda: sharding.shard_cache(lm.init_cache(cfg, 4, 62, device="cpu"), cfg,
                                             mesh),
                lambda: lm.init_cache(cfg, 4, 62, device="cpu", mesh=mesh)):
        with pytest.raises(ValueError, match="do not divide"):
            bad()
    for arch in ("seamless-m4t-medium", "xlstm-1.3b"):
        c = get_smoke_config(arch)
        whole = lm.init_cache(c, 4, 62, enc_len=3, device="cpu")
        assert sharding.shard_cache(whole, c, mesh) is whole


def test_mesh_entry_points_raise_without_cuda(monkeypatch):
    """On a mesh too the entry points want the card unless told the CPU."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("granite-moe-1b-a400m")
    for entry in (lambda: lm.init_params(cfg, mesh=_Mesh((2, 4))),
                  lambda: serve.Server(cfg, batch=4, max_len=8, mesh=_Mesh((2, 4)))):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()


# ---------------------------------------------------------------------------
# the JAX side: this file as a script on 8 forced host devices
# ---------------------------------------------------------------------------

def _jax_serve(cfg, params, inp, jmesh) -> np.ndarray:
    """The reference's serve loop (``repro.launch.serve.main``) over the
    case's requests, its params replaced by the case's."""
    srv = jserve.Server(cfg, T.LM_MESH_BATCH, T.LM_MESH_MAX_LEN, mesh=jmesh)
    srv.params = params
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


def _jax_case(case, cfg, inp, jmesh):
    dt = getattr(jnp, case["dtype"])
    kind, n = case["kind"], jnp.int32(case.get("len", 0))
    if kind == "attn":
        q, k, v = (jnp.asarray(inp[x], dt) for x in "qkv")
        return jax.jit(lambda *a: jL.sharded_decode_attention(*a, jmesh))(q, k, v, n)
    if kind == "mla":
        q_c = jnp.asarray(inp["q_c"])
        rest = [jnp.asarray(inp[x], dt) for x in ("q_pe", "ckv", "kpe")]
        return jax.jit(lambda *a: jlm._mla_latent_attention(*a, T.mla_scale(cfg), jmesh))(
            q_c, *rest, n)
    if kind == "moe":
        args = [jnp.asarray(inp[x], dt) for x in ("x", "router", "e_gate", "e_in", "e_out")]
        return jax.jit(lambda *a: jL.moe_block(*a, cfg, mesh=jmesh))(*args)
    params = jax.tree.map(lambda a: jnp.asarray(a, dt), inp["params"])
    if kind == "serve":
        return _jax_serve(cfg, params, inp, jmesh)
    # the port's prefill and decode on a mesh are tensor parallel where the
    # family is (sharding.tensor_parallel): the reference's program for them
    # is its GSPMD partitioning of params placed under param_pspecs
    if jmesh is not None:
        specs = jsharding.param_pspecs(cfg, jlm.param_shapes(cfg), jmesh)
        params = jax.device_put(params, jax.tree.map(lambda s: NamedSharding(jmesh, s), specs))
    logits, cache = jax.jit(lambda p, t: jlm.prefill(p, cfg, t, T.LM_MESH_MAX_LEN,
                                                     mesh=jmesh))(params, inp["prompt"])
    step = jax.jit(jlm.make_decode_step(cfg, mesh=jmesh))
    out = [logits]
    for tok in inp["steps"]:
        lg, cache = step(params, cache, jnp.asarray(tok))
        out.append(lg)
    return jnp.stack(out)


def jax_side(shape, out_dir) -> None:
    """Every case of ``shape`` through the reference on a mesh of the
    forced host devices; saves ``jax_<shape>.npz`` (``testing.mesh_tag``).
    A (pod, data, model) mesh is the production builder's axes on 8
    devices."""
    from repro.core.mesh import make_host_mesh
    assert jax.device_count() == 8, jax.devices()
    jmesh = (make_host_mesh(*shape) if len(shape) == 2 else jax.make_mesh(
        shape, _names(shape), axis_types=(jax.sharding.AxisType.Auto,) * 3))
    res = {}
    for case in T.lm_mesh_cases(shape):
        cfg = T.lm_mesh_config(case, j_smoke)
        inp = T.lm_mesh_inputs(case, cfg)
        res[case["label"]] = np.asarray(_jax_case(case, cfg, inp, jmesh), np.float32)
        if case["label"].endswith(CLAMPED) or T.spread_case(case):
            res[case["label"] + ONE_DEVICE] = np.asarray(_jax_case(case, cfg, inp, None),
                                                         np.float32)
    np.savez(Path(out_dir) / f"jax_{T.mesh_tag(shape)}.npz", **res)


# ---------------------------------------------------------------------------
# the two sides, in subprocesses
# ---------------------------------------------------------------------------

def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the 8 gloo ranks and one JAX process a mesh shape together;
    returns (the results' directory, the ranks' standard output)."""
    out = tmp_path_factory.mktemp("lm_mesh")
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    jenv = _env(JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
        flags + ["--xla_force_host_platform_device_count=8"]))
    procs = {f"jax {s}": subprocess.Popen(
        [sys.executable, __file__, T.mesh_tag(s), str(out)], env=jenv,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for s in SHAPES}
    procs["ranks"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.testing", "lm-mesh", "--ways", "8",
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
    return out, outputs["ranks"][0]


def test_ranks_hold_each_case_to_one_device(runs):
    """Every case printed its line on rank 0 (``OK`` against the rank's
    one-device run, or, where the capacity counts the rank's tokens, held
    to JAX only); FSDP's gather gave the whole weights back."""
    _, stdout = runs
    for shape in SHAPES:
        for case in T.lm_mesh_cases(shape):
            line = next((ln for ln in stdout.splitlines()
                         if ln.startswith(case["label"] + ":")), None)
            assert line is not None, case["label"]
            local_t = (case.get("t", 0) // shape[0] if shape[0] > 1 else case.get("t", 0))
            want = ("held to JAX only" if case["kind"] == "moe" and case["t"] > 256
                    and shape[0] > 1 else "OK")
            assert line.endswith(want), line
            if case["kind"] == "moe":
                split = case["experts"] % shape[1] == 0
                assert ("split over model" if split else "E % model != 0") in line, line
                assert f"{local_t} tokens a rank" in line, line
    assert "_gather_fsdp over data=2" in stdout and stdout.rstrip().endswith(
        "lm-mesh suite: OK")


CASES = [(shape, case["label"]) for shape in SHAPES for case in T.lm_mesh_cases(shape)]


@pytest.mark.parametrize("shape,label", CASES, ids=[c[1] for c in CASES])
def test_every_rank_matches_jax_shard_map(runs, shape, label):
    out, _ = runs
    with np.load(out / f"jax_{T.mesh_tag(shape)}.npz") as z:
        want = z[label]
        one = z[label + ONE_DEVICE] if label.endswith(CLAMPED) else None
    tol = T.lm_tol(label.split("/")[2])
    for rank in range(8):
        with np.load(out / f"rank{rank}.npz") as z:
            got = z[label]
        assert got.shape == want.shape, (rank, got.shape, want.shape)
        if "/serve/" in label:
            np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")
        elif one is not None:
            # the last step writes at len == max_len: lax.dynamic_update_slice
            # clamps the write to the last slot, as the port does on one
            # device and on a mesh, but XLA's partitioned update of the
            # S-sharded cache drops it. So: the reference on one device at
            # every step, its shard_map up to that step.
            np.testing.assert_allclose(got, one, rtol=tol, atol=tol,
                                       err_msg=f"{label} rank {rank} (one device)")
            np.testing.assert_allclose(got[:-1], want[:-1], rtol=tol, atol=tol,
                                       err_msg=f"{label} rank {rank}")
            assert not np.allclose(want[-1], one[-1], rtol=tol, atol=tol)
        else:
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                       err_msg=f"{label} rank {rank}")


SPREAD = [(shape, case["label"]) for shape in SHAPES for case in T.lm_mesh_cases(shape)
          if T.spread_case(case)]


@pytest.mark.parametrize("shape,label", SPREAD, ids=[c[1] for c in SPREAD])
def test_spread_case_holds_to_one_device(runs, shape, label):
    """zamba2 in bfloat16 (``testing.spread_case``): each rank's mesh
    logits against its own one-device run at ``testing.spread_bar``,
    ``lm_tol`` more than the reference's own mesh-to-one-device spread in
    the same case, which is past ``lm_tol``: the reference's
    tensor-parallel program rounds its partial sums otherwise than its
    one-device program, as the port's does."""
    out, _ = runs
    with np.load(out / f"jax_{T.mesh_tag(shape)}.npz") as z:
        spread = float(np.abs(z[label] - z[label + ONE_DEVICE]).max())
    dtype = label.split("/")[2]
    assert spread > T.lm_tol(dtype), spread
    bar = T.spread_bar(dtype, spread)
    for rank in range(8):
        with np.load(out / f"rank{rank}.npz") as z:
            got, one = z[label], z[label + ONE_DEVICE]
        np.testing.assert_allclose(got, one, rtol=bar, atol=bar,
                                   err_msg=f"{label} rank {rank} against its one device")


if __name__ == "__main__":
    jax_side(tuple(int(n) for n in sys.argv[1].split("x")), sys.argv[2])
