"""The port's training on a (data, model) mesh against the JAX package's, on
the CPU.

In subprocesses, started together: ``python -m repro_torch.testing
train-mesh`` (8 gloo ranks, then a new group of 4 that restores a
checkpoint), and this file run as a script (the JAX side) for each of
four groups of work on 8 forced host devices
(``--xla_force_host_platform_device_count=8``). Both take the cases of
``repro_torch.testing.train_mesh_cases`` with the same seeded weights and
batches: two steps of ``make_train_step(mesh=)`` at microbatches 2 with
AdamW (lr 1e-2, eps 1e-3) for dense, FSDP, M-RoPE, encoder-decoder, hybrid
and MoE configs on (8, 1), (2, 4), (4, 2) and (1, 8), a microbatch of 2
rows on data 4 (replicated), a clip that binds, and FSDP and MoE configs
on a (2, 2, 2) (pod, data, model) mesh (rows over pod and data, FSDP over
data). Each rank's losses and
its blocks of the params and both moments are held to the reference at the
port's training bars: the loss at 2e-4, every leaf at 2e-4 of its largest
|value| (``tests/test_torch_train_grads.py``). The reference is its jitted
mesh step, but for an MoE whose experts split over more than one ``model``
rank, where its ``shard_map``'s gradient is not the gradient of its loss
(ROADMAP §3, pinned here by
``test_reference_mesh_moe_gradient_is_not_its_loss_gradient``): there the
port is held to the reference's one-device step, at a size where capacity
drops nothing (the ranks count 0 drops).

Also against JAX: ``compressed_psum`` over 8 ranks whose scales differ (the
reference's ``shard_map``), ``elastic.reshard_state`` from (2, 4) to (4, 2)
and two more steps (the reference's ``device_put``), a checkpoint saved from
(2, 4) and restored on a new 4-rank group as (1, 4), then stepped (the
reference's ``restore(shardings=)`` on 4 devices). The checkpoint saved
from the mesh is the file one process writes of the same state, and the
reference reads it.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax.sharding import AbstractMesh

from repro.configs import ARCHS as J_ARCHS, get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import lm as jlm, sharding as jsharding
from repro.train import checkpoint as jckpt
from repro_torch import testing as T
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import lm, sharding

SRC = Path(__file__).resolve().parent.parent / "src"
# each subprocess's, above the group's: run beside the tensor-parallel
# suite's sixteen processes on 8 cores, the JAX side took over 300 s
RUN_TIMEOUT_S = 900
CASES = T.train_mesh_cases()
# one JAX process each: cases, then the extras by name
JAX_GROUPS = ((CASES[:5], ()), (CASES[5:8], ()), (CASES[8:14], ("compress",)),
              (CASES[14:], ("pin", "reshard")))
PIN = "finding2"  # the reference's mesh MoE gradient against its one-device one


# ---------------------------------------------------------------------------
# the JAX side: this file as a script on 8 forced host devices
# ---------------------------------------------------------------------------

def _names(shape) -> tuple:
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _jmesh(shape, n_devices=None):
    from jax.sharding import AxisType, Mesh
    devs = np.array(jax.devices()[:n_devices or int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, _names(shape), axis_types=(AxisType.Auto,) * len(shape))


def _placed(tree, cfg, jmesh):
    from jax.sharding import NamedSharding
    specs = jsharding.param_pspecs(cfg, jlm.param_shapes(cfg), jmesh)
    return jax.device_put(tree, jax.tree.map(lambda s: NamedSharding(jmesh, s), specs))


def _state_shardings(cfg, jmesh):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.train.optim import AdamWState
    specs = jsharding.param_pspecs(cfg, jlm.param_shapes(cfg), jmesh)
    ns = jax.tree.map(lambda s: NamedSharding(jmesh, s), specs)
    return ns, AdamWState(step=NamedSharding(jmesh, P()), mu=ns, nu=ns)


def _jflat(params, state) -> dict:
    out = {}
    for name, tree in (("params", params), ("mu", state.mu), ("nu", state.nu)):
        for path, v in jax.tree_util.tree_leaves_with_path(tree):
            out[name + "/" + "/".join(str(p.key) for p in path)] = np.asarray(v, np.float32)
    return out


def _jsteps(cfg, params, state, batches, jmesh, clip=1.0):
    from repro.train.optim import AdamW
    opt = AdamW(lr=T.TRAIN_MESH_LR, eps=T.TRAIN_MESH_EPS, grad_clip=clip)
    step = jax.jit(jlm.make_train_step(cfg, opt, microbatches=T.TRAIN_MESH_MICRO,
                                       mesh=jmesh))
    if state is None:
        state = opt.init(params)
    losses = []
    for b in batches:
        params, state, m = step(params, state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return params, state, losses


def _jax_case(case) -> dict:
    cfg = T.train_mesh_config(case, j_smoke)
    inp = T.train_mesh_inputs(case, cfg)
    params = jax.tree.map(jnp.asarray, inp["params"])
    jmesh = None
    if case["ref"] == "mesh":
        jmesh = _jmesh(case["shape"])
        params = _placed(params, cfg, jmesh)
    params, state, losses = _jsteps(cfg, params, None, inp["batches"], jmesh, case["clip"])
    out = {f"{case['label']}/{k}": v for k, v in _jflat(params, state).items()}
    out[f"{case['label']}/loss"] = np.asarray(losses, np.float64)
    return out


def _jax_compress() -> dict:
    from jax.sharding import PartitionSpec as P
    from repro.train import compress as jcompress
    g, err = T.compress_inputs(8)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))

    def body(g, e):
        sq = lambda t: jax.tree.map(lambda a: a[0], t)
        mean, new = jcompress.compressed_psum(sq(g), sq(e), "data")
        return jax.tree.map(lambda a: a[None], (mean, new))

    mean, new = jax.jit(jax.shard_map(body, mesh=jmesh, in_specs=(P("data"), P("data")),
                                      out_specs=(P("data"), P("data"))))(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, err))
    return {f"compress/{name}/{k}": np.asarray(v) for name, tree in (("mean", mean),
                                                                    ("err", new))
            for k, v in tree.items()}


def _jax_reshard_and_restore(tmp) -> dict:
    """``RESHARD``: 2 steps on (2, 4), a checkpoint, ``reshard_state`` onto
    (4, 2) and 2 steps; the checkpoint restored with the shardings of a
    (1, 4) mesh of 4 devices and 2 steps there."""
    from repro.train import elastic as jelastic
    arch, before, after = T.RESHARD
    case = dict(arch=arch, b=T.TRAIN_MESH_BATCH, fsdp=True, remat=False, experts=None,
                clip=1.0, label=f"reshard/{arch}")
    cfg = T.train_mesh_config(case, j_smoke)
    inp = T.train_mesh_inputs(case, cfg)
    batches = T.train_mesh_batches(cfg, case["b"], 99, 2 * T.TRAIN_MESH_STEPS)
    m1 = _jmesh(before)
    params = _placed(jax.tree.map(jnp.asarray, inp["params"]), cfg, m1)
    params, state, losses = _jsteps(cfg, params, None, batches[:T.TRAIN_MESH_STEPS], m1)
    out = {f"reshard/before/{k}": v for k, v in _jflat(params, state).items()}
    jckpt.save(tmp, T.TRAIN_MESH_STEPS, (params, state), cfg=cfg)
    m2 = _jmesh(after)
    p2, s2 = jelastic.reshard_state((params, state), cfg, jlm.param_shapes(cfg), m2)
    p2, s2, more = _jsteps(cfg, p2, s2, batches[T.TRAIN_MESH_STEPS:], m2)
    out.update({f"reshard/after/{k}": v for k, v in _jflat(p2, s2).items()})
    out["reshard/loss"] = np.asarray(losses + more, np.float64)
    m3 = _jmesh(T.RESTORE_SHAPE, 4)
    (p3, s3), at = jckpt.restore(tmp, (params, state), cfg=cfg,
                                 shardings=_state_shardings(cfg, m3))
    assert at == T.TRAIN_MESH_STEPS
    p3, s3, again = _jsteps(cfg, p3, s3, batches[T.TRAIN_MESH_STEPS:], m3)
    out.update({f"restore/{k}": v for k, v in _jflat(p3, s3).items()})
    out["restore/loss"] = np.asarray(again, np.float64)
    return out


PINS = {"2x4": ((2, 4), None), "1x8/e8": ((1, 8), 8)}  # mesh, expert count


def _jax_pin() -> dict:
    """The reference's loss and gradient of granite-moe's smoke config on
    each ``PINS`` mesh and on one device, for one microbatch of 192 tokens
    (dropless on both)."""
    out = {}
    for pin, (shape, experts) in PINS.items():
        case = dict(arch="granite-moe-1b-a400m", b=T.TRAIN_MESH_BATCH, fsdp=False,
                    remat=False, experts=experts, clip=1.0, label=f"{PIN}/{pin}")
        cfg = T.train_mesh_config(case, j_smoke)
        inp = T.train_mesh_inputs(case, cfg)
        half = case["b"] // T.TRAIN_MESH_MICRO
        batch = {k: jnp.asarray(v[:half]) for k, v in inp["batches"][0].items()}
        params = jax.tree.map(jnp.asarray, inp["params"])
        jmesh = _jmesh(shape)
        for tag, mesh, p in (("mesh", jmesh, _placed(params, cfg, jmesh)),
                             ("one", None, params)):
            loss, g = jax.jit(jax.value_and_grad(
                lambda p, b: jlm.loss_fn(p, cfg, b, mesh=mesh)))(p, batch)
            out[f"{PIN}/{pin}/{tag}/loss"] = np.asarray(loss, np.float64)
            for path, v in jax.tree_util.tree_leaves_with_path(g):
                out[f"{PIN}/{pin}/{tag}/" + "/".join(str(q.key) for q in path)] = np.asarray(v)
    return out


def jax_side(group: int, out_dir) -> None:
    """Group ``group`` of ``JAX_GROUPS`` through the reference; saves
    ``jax_<group>.npz``."""
    import tempfile
    assert jax.device_count() == 8, jax.devices()
    cases, extras = JAX_GROUPS[group]
    res = {}
    for case in cases:
        res.update(_jax_case(case))
    if "compress" in extras:
        res.update(_jax_compress())
    if "pin" in extras:
        res.update(_jax_pin())
    if "reshard" in extras:
        with tempfile.TemporaryDirectory() as tmp:
            res.update(_jax_reshard_and_restore(tmp))
    np.savez(Path(out_dir) / f"jax_{group}.npz", **res)


# ---------------------------------------------------------------------------
# the two sides, in subprocesses
# ---------------------------------------------------------------------------

def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the gloo ranks and the JAX processes together; returns (the
    results' directory, the ranks' standard output, JAX's results)."""
    out = tmp_path_factory.mktemp("train_mesh")
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    jenv = _env(JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
        flags + ["--xla_force_host_platform_device_count=8"]))
    procs = {f"jax {g}": subprocess.Popen(
        [sys.executable, __file__, str(g), str(out)], env=jenv,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for g in range(len(JAX_GROUPS))}
    procs["ranks"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.testing", "train-mesh", "--ways", "8",
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
    for g in range(len(JAX_GROUPS)):
        with np.load(out / f"jax_{g}.npz") as z:
            want.update({k: z[k] for k in z.files})
    return out, outputs["ranks"][0], want


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("shape", [(2, 4), (8, 1), (2, 2, 2)])
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_train_specs_keep_data_and_the_experts_model(arch, shape):
    """The training placement of the full configs against the reference's
    ``param_pspecs`` on an ``AbstractMesh``: each leaf keeps the reference's
    ``data`` entries (FSDP configs) but on the experts, and its ``model``
    entries on the leaves of ``sharding.model_leaves`` (the experts where
    ``moe_block`` splits them; every family's leaves of
    ``sharding.tp_leaves`` that the reference splits over ``model``, those
    split by head only where the heads divide) and nothing else."""
    jcfg, tcfg = j_config(arch), get_config(arch)
    want = dict(_flat(jsharding.param_pspecs(jcfg, jlm.param_shapes(jcfg),
                                             AbstractMesh(shape, _names(shape)))))
    got = dict(_flat(sharding.train_specs(tcfg, lm.param_shapes(tcfg), _Mesh(shape))))
    assert set(got) == set(want)
    keep = sharding.model_leaves(tcfg, _Mesh(shape))
    experts = {f"blocks/{e}" for e in sharding.EXPERTS}
    assert (experts <= keep) == sharding.sharded_experts(tcfg, _Mesh(shape))
    heads, other, _ = sharding.tp_leaves(tcfg)
    assert (keep - experts) == {
        k for k in set(other) | (set(heads) if tcfg.n_heads % shape[-1] == 0 else set())
        if "model" in tuple(want[k])}
    n_data = n_model = 0
    for k, p in want.items():
        leaf = k.rsplit("/", 1)[-1]
        entries = tuple(None if e is None else (e,) if isinstance(e, str) else tuple(e)
                        for e in p)
        entries += (None,) * (len(got[k]) - len(entries))
        assert got[k] == tuple(
            e if e is not None and (("model" in e and k in keep)
                                    or ("data" in e and leaf not in sharding.EXPERTS))
            else None for e in entries), k
        n_data += ("data",) in got[k]
        n_model += ("model",) in got[k] and leaf not in sharding.EXPERTS
    assert (n_data > 0) == (tcfg.fsdp and shape[-2] > 1)
    assert n_model > 0


class _Mesh:
    """A stand-in for a (data, model) or (pod, data, model) mesh of the
    port: its shape, and the coordinates of ``rank`` (``make_host_mesh``'s
    row-major rank, ``d * model + m`` or ``(p * data + d) * model + m``)."""

    def __init__(self, shape, rank=0):
        self.shape, self.rank = shape, rank
        self.mesh_dim_names = _names(shape)

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, axis):
        coords = np.unravel_index(self.rank, self.shape)
        return int(coords[self.mesh_dim_names.index(axis)])


PARTS = ("params", "mu", "nu")


def _state_keys(tree: dict, prefix: str) -> list:
    return [k for k in tree if k.startswith(tuple(f"{prefix}/{p}/" for p in PARTS))]


def _hold(got: dict, want: dict, prefix: str, cfg, shape, rank, label, losses):
    """``rank``'s blocks of the params and moments saved under ``prefix``
    against JAX's whole leaves cut to the same blocks of the port's
    placement on ``shape`` (each at ``TRAIN_MESH_TOL`` of the whole leaf's
    largest |value|), and ``losses`` (got, want)."""
    import torch
    mesh = _Mesh(shape, rank)
    specs = T.flat_tree(sharding.train_specs(cfg, lm.param_shapes(cfg), mesh))
    keys = _state_keys(want, prefix)
    assert sorted(_state_keys(got, prefix)) == sorted(keys), label
    for key in keys:
        w = want[key]
        spec = specs[key[len(prefix) + 1:].split("/", 1)[1]]
        blk = sharding.place_leaf(torch.from_numpy(w), spec, mesh).numpy()
        g = got[key]
        assert g.shape == blk.shape, (label, key, g.shape, blk.shape)
        np.testing.assert_allclose(g, blk, rtol=T.TRAIN_MESH_TOL,
                                   atol=T.TRAIN_MESH_TOL * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=f"{label} rank {rank} {key}")
    np.testing.assert_allclose(losses[0], losses[1], rtol=T.TRAIN_MESH_TOL,
                               atol=T.TRAIN_MESH_TOL, err_msg=f"{label} rank {rank} losses")


def _rank(out, r, name="rank"):
    with np.load(out / f"{name}{r}.npz") as z:
        return {k: z[k] for k in z.files}


def test_ranks_hold_each_case_to_one_device(runs):
    """Every case printed its line on rank 0: the ranks' losses, params and
    moments equal their own one-device run's, with no token dropped."""
    _, stdout, _ = runs
    for case in CASES:
        line = next((ln for ln in stdout.splitlines() if ln.startswith(case["label"] + ":")),
                    None)
        assert line is not None, case["label"]
        assert line.endswith(": OK") and ", 0 tokens dropped" in line, line
        ways = int(np.prod(case["shape"][:-1]))  # the batch axes' ranks
        split = case["b"] // T.TRAIN_MESH_MICRO % ways == 0 and ways > 1
        assert ("rows split over data" if split else "rows replicated") in line, line
    assert "compressed_psum over data=8" in stdout
    assert "train-mesh suite: OK" in stdout and stdout.rstrip().endswith(
        "train-restore suite: OK")


@pytest.mark.parametrize("case", CASES, ids=[c["label"] for c in CASES])
def test_every_rank_matches_jax(runs, case):
    """Each rank's losses and its blocks of the params and moments after two
    steps against the reference (its mesh step, or its one-device step for
    an MoE whose experts split over ``model``)."""
    out, _, want = runs
    cfg = T.train_mesh_config(case, get_smoke_config)
    for r in range(8):
        got = _rank(out, r)
        assert int(got[f"{case['label']}/drops"]) == 0
        loss = f"{case['label']}/loss"
        _hold(got, want, case["label"], cfg, case["shape"], r, case["label"],
              (got[loss], want[loss]))


@pytest.mark.parametrize("pin", sorted(PINS))
def test_reference_mesh_moe_gradient_is_not_its_loss_gradient(runs, pin):
    """Pins the reference's fault: with granite-moe's experts split over
    ``model`` (on (2, 4), and on (1, 8) with 8 experts) its mesh loss
    equals the one-device loss, but ``jax.value_and_grad`` of the mesh
    ``loss_fn`` differs from the one-device gradient, the router's and
    most other leaves' by far more than rounding (ROADMAP §3). A JAX that
    fixes it fails here, and those MoE cases can then be held to the mesh
    step."""
    _, _, want = runs
    key = f"{PIN}/{pin}"
    np.testing.assert_allclose(want[f"{key}/mesh/loss"], want[f"{key}/one/loss"], rtol=1e-6)
    leaves = [k[len(f"{key}/one/"):] for k in want if k.startswith(f"{key}/one/")
              and not k.endswith("/loss")]
    rel = {}
    for name in leaves:
        m, o = want[f"{key}/mesh/{name}"], want[f"{key}/one/{name}"]
        rel[name] = float(np.abs(m - o).max() / max(np.abs(o).max(), 1e-30))
    assert rel["blocks/router"] > 0.1, rel
    assert sum(v > 1e-2 for v in rel.values()) >= len(rel) // 2, rel


def test_compressed_psum_across_ranks_matches_jax(runs):
    """Each rank's mean (``sum(q) * max(scale) / n``) and its new error
    feedback against the reference's ``shard_map`` over 8 devices. The
    error is ``g - q * scale``, a difference of terms of |g|'s size: it is
    held to a few float32 ulps of that size."""
    out, _, want = runs
    g, _ = T.compress_inputs(8)
    for r in range(8):
        got = _rank(out, r)
        for k in [k for k in want if k.startswith("compress/")]:
            size = float(np.abs(g[k.rsplit("/", 1)[1]][r]).max())
            atol = 1e-7 if k.startswith("compress/mean/") else 4 * 2.0 ** -23 * size
            np.testing.assert_allclose(got[k], want[k][r], rtol=1e-6, atol=atol,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("half", ["before", "after"])
def test_reshard_state_matches_jax(runs, half):
    """2 steps on (2, 4), then ``reshard_state`` onto (4, 2) and 2 more."""
    out, _, want = runs
    arch, before, after = T.RESHARD
    case = dict(arch=arch, fsdp=True, remat=False, experts=None)
    cfg = T.train_mesh_config(case, get_smoke_config)
    shape, n = (before, T.TRAIN_MESH_STEPS) if half == "before" else (after, None)
    for r in range(8):
        got = _rank(out, r)
        _hold(got, want, f"reshard/{half}", cfg, shape, r, f"reshard {half}",
              (got["reshard/loss"][:n], want["reshard/loss"][:n]))


def test_checkpoint_restored_on_a_new_group_matches_jax(runs):
    """The checkpoint saved from (2, 4) restored on a new group of 4 ranks
    as (1, 4) and stepped twice, against the reference's ``restore`` with
    the shardings of a (1, 4) mesh of 4 devices and the same two steps."""
    out, _, want = runs
    cfg = T.train_mesh_config(dict(arch=T.RESHARD[0], fsdp=True, remat=False, experts=None),
                              get_smoke_config)
    for r in range(4):
        got = _rank(out, r, "restore")
        assert int(got["restore/step"]) == 2 * T.TRAIN_MESH_STEPS
        _hold(got, want, "restore", cfg, T.RESTORE_SHAPE, r, "restore",
              (got["restore/loss"], want["restore/loss"]))


def test_checkpoint_from_a_mesh_is_the_one_device_file(runs):
    """The mesh's save (every placed leaf gathered whole, written once)
    equals one process's save of the same whole state, array for array and
    manifest for manifest, and the reference restores it."""
    out, _, _ = runs
    step = f"step_{T.TRAIN_MESH_STEPS:08d}"
    a, b = out / "ckpt_mesh" / step, out / "ckpt_one" / step
    assert json.loads((a / "manifest.json").read_text()) == json.loads(
        (b / "manifest.json").read_text())
    with np.load(a / "shard_0.npz") as za, np.load(b / "shard_0.npz") as zb:
        assert za.files == zb.files
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), k
    from repro.train.optim import AdamW as JAdamW
    jcfg = T.train_mesh_config(dict(arch=T.RESHARD[0], fsdp=True, remat=False,
                                    experts=None), j_smoke)
    p = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    (pj, sj), at = jckpt.restore(str(out / "ckpt_mesh"), (p, JAdamW().init(p)), cfg=jcfg)
    assert at == T.TRAIN_MESH_STEPS and int(sj.step) == T.TRAIN_MESH_STEPS
    with np.load(a / "shard_0.npz") as za:
        np.testing.assert_array_equal(np.asarray(pj["blocks"]["wq"]), za["0/blocks/wq"])


if __name__ == "__main__":
    jax_side(int(sys.argv[1]), sys.argv[2])
