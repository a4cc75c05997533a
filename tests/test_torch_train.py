"""The port's training substrate, on the CPU: ``tests/test_train_infra.py``'s
checks against ``repro_torch.train``, ``data.tokens`` and ``launch.train``,
and what crosses between the packages.

Checkpoint/restart resume, preemption, retention, the config-hash guard,
elastic re-mesh planning, the straggler watchdog, gradient compression
with error feedback (``compressed_psum`` on a one-rank gloo group), the
token pipeline's determinism and sharding, and the loss falling over a
short run, as the reference's tests hold them. Then: ``TokenPipeline``'s
batches byte-equal to the reference's for any (seed, host, hosts, step)
and after ``restore``; a checkpoint written by ``repro.train.checkpoint``
restores bit for bit through the port's ``restore`` and the reverse;
``config_hash`` equal in both packages for all ten configs.
"""
import dataclasses
import datetime
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as J_ARCHS, get_config as j_config, \
    get_smoke_config as j_smoke
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.models import lm as jlm
from repro.train import checkpoint as jckpt
from repro.train.optim import AdamW as JAdamW
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import mesh as mesh_util
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compress, elastic
from repro_torch.train.loop import train
from repro_torch.train.optim import AdamW, tree_leaves
from repro_torch.train.stragglers import PreemptionGuard, StragglerWatchdog

ARCH = "granite-3-2b"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op threads spin when the test workers share the cores;
    one thread keeps a module's small CPU ops fast under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(cfg, seed=0):
    return lm.init_params(cfg, seed, device="cpu")


def _bits(x) -> np.ndarray:
    """A leaf's bytes as an integer array: bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16
                else x.numpy())
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group for the duration of a test."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# tests/test_train_infra.py's checks, against the port
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    cfg = get_smoke_config(ARCH)
    params = _params(cfg)
    opt = AdamW()
    state = (params, opt.init(params), (3, 17))
    path = ckpt.save(str(tmp_path), 5, state, cfg=cfg)
    assert os.path.exists(os.path.join(path, "manifest.json"))
    restored, step = ckpt.restore(str(tmp_path), state, cfg=cfg)
    assert step == 5
    assert restored[2] == (3, 17) and type(restored[1]).__name__ == "AdamWState"
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert type(a) is type(b)
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_checkpoint_config_mismatch_refused(tmp_path):
    cfg = get_smoke_config(ARCH)
    params = _params(cfg)
    ckpt.save(str(tmp_path), 1, params, cfg=cfg)
    other = dataclasses.replace(cfg, d_ff=cfg.d_ff * 2)
    with pytest.raises(ValueError, match="hash mismatch"):
        ckpt.restore(str(tmp_path), params, cfg=other)


def test_checkpoint_retention(tmp_path):
    cfg = get_smoke_config(ARCH)
    params = _params(cfg)
    for s in range(1, 6):
        ckpt.save(str(tmp_path), s, params, cfg=cfg, keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2 and steps[-1] == "step_00000005"
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_")]


def test_train_resume_bit_identical(tmp_path):
    """Uninterrupted 6-step run == 3 steps + kill + resume for 3 more."""
    cfg = get_smoke_config(ARCH)
    full = train(cfg, steps=6, batch=2, seq=16, seed=3, device="cpu")
    d = str(tmp_path / "ck")
    train(cfg, steps=3, batch=2, seq=16, seed=3, ckpt_dir=d, ckpt_every=3, device="cpu")
    part2 = train(cfg, steps=6, batch=2, seq=16, seed=3, ckpt_dir=d, ckpt_every=3,
                  device="cpu")
    assert part2.resumed_from == 3 and part2.step == 6
    np.testing.assert_allclose(full.losses[3:], part2.losses, rtol=1e-5)


def test_preemption_checkpoints_and_stops(tmp_path):
    cfg = get_smoke_config(ARCH)
    guard = PreemptionGuard(install=False)

    def hook(step, m):
        if step == 2:
            guard.trigger()

    d = str(tmp_path / "ck")
    res = train(cfg, steps=100, batch=2, seq=16, ckpt_dir=d, ckpt_every=1000,
                guard=guard, hook=hook, device="cpu")
    assert res.preempted and res.step == 3
    assert ckpt.latest_step(d) == 3  # saved at the preempted step


def test_elastic_plan():
    assert elastic.plan_new_mesh(512, 16) == (32, 16, 0)
    assert elastic.plan_new_mesh(480, 16) == (30, 16, 0)   # lost 2 hosts
    assert elastic.plan_new_mesh(250, 16) == (15, 16, 10)  # idle remainder
    assert elastic.plan_new_mesh(8, 16) == (1, 8, 0)       # tiny survivor set


def test_elastic_remesh_on_one_rank(one_rank):
    mesh, idle = elastic.remesh(16, device="cpu")
    assert idle == 0 and mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)


def test_straggler_watchdog_evicts_and_reassigns():
    wd = StragglerWatchdog(n_hosts=4, threshold=1.5, strikes_to_act=2)
    normal = {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0}
    assert wd.observe(normal) == []
    slow = {0: 1.0, 1: 1.0, 2: 1.0, 3: 5.0}
    assert wd.observe(slow) == []          # first strike
    assert wd.observe(slow) == [3]         # second strike -> evict
    shards = {0: [0, 1], 1: [2, 3], 2: [4, 5], 3: [6, 7]}
    out = wd.reassignment(shards)
    assert 3 not in out
    assert sorted(x for v in out.values() for x in v) == list(range(8))


def test_gradient_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    grads = {"w": g}
    err = compress.init_error(grads)
    (q, s), err = compress.compress_tree(grads, err)
    assert q["w"].dtype == torch.int8
    deq = compress.decompress_tree((q, s))
    rel = float(torch.linalg.norm(deq["w"] - g) / torch.linalg.norm(g))
    assert rel < 0.02  # int8 quantization error bound
    # error feedback: accumulated (deq + err) recovers g exactly
    np.testing.assert_allclose((deq["w"] + err["w"]).numpy(), g.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_gradient_compression_matches_jax():
    """The same int8 values and scales as the reference's (round half to
    even on both sides)."""
    from repro.train import compress as jcompress
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((32, 16)).astype(np.float32),
            "b": [rng.standard_normal(7).astype(np.float32) * 1e-3]}
    err = {"a": rng.standard_normal((32, 16)).astype(np.float32) * 1e-2,
           "b": [np.zeros(7, np.float32)]}
    (jq, js), je = jcompress.compress_tree(jax.tree.map(jnp.asarray, tree),
                                           jax.tree.map(jnp.asarray, err))
    t = lambda tr: jax.tree.map(torch.from_numpy, tr)
    (tq, ts), te = compress.compress_tree(t(tree), t(err))
    for a, b in zip(jax.tree.leaves(jq), tree_leaves(tq)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree.leaves((js, je)), tree_leaves((ts, te))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-9)


def test_compressed_psum_one_rank(one_rank):
    mesh = mesh_util.make_host_mesh(1, 1, device="cpu")
    g = {"w": torch.ones((8, 8)) * 0.5}
    err = compress.init_error(g)
    out, err2 = compress.compressed_psum(g, err, mesh, "data")
    np.testing.assert_allclose(out["w"].numpy(), 0.5, rtol=1e-2)
    np.testing.assert_allclose((out["w"] + err2["w"]).numpy(), 0.5, rtol=1e-6)


def test_token_pipeline_determinism_and_sharding():
    p1 = TokenPipeline(vocab=100, batch=8, seq=16, seed=1)
    p2 = TokenPipeline(vocab=100, batch=8, seq=16, seed=1)
    b1, b2 = p1.next_batch(), p2.next_batch()
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    # disjoint host shards
    h0 = TokenPipeline(vocab=100, batch=8, seq=16, seed=1, host_id=0, num_hosts=2)
    h1 = TokenPipeline(vocab=100, batch=8, seq=16, seed=1, host_id=1, num_hosts=2)
    a, b = h0.next_batch(), h1.next_batch()
    assert a["tokens"].shape == (4, 16)
    assert not np.array_equal(a["tokens"], b["tokens"])
    # seekability (checkpoint/restore)
    st = p1.state()
    nxt = p1.next_batch()
    p1.restore(st)
    np.testing.assert_array_equal(p1.next_batch()["tokens"], nxt["tokens"])


def test_loss_goes_down_over_short_run():
    cfg = get_smoke_config(ARCH)
    res = train(cfg, steps=12, batch=4, seq=32, lr=3e-3, seed=0, device="cpu")
    assert np.mean(res.losses[-3:]) < np.mean(res.losses[:3])


def test_launcher_smoke_on_cpu(capsys):
    handler = signal.getsignal(signal.SIGTERM)  # the launcher installs its guard
    try:
        launch_train.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
                           "--seq", "16", "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, handler)
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "done: step=2" in out and "resumed_from=None" in out


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,host_id,num_hosts,step", [
    (0, 0, 1, 0), (3, 1, 2, 5), (7, 3, 4, 11), (123, 0, 8, 2)])
def test_token_pipeline_byte_equal_to_jax(seed, host_id, num_hosts, step):
    kw = dict(vocab=49155, batch=16, seq=33, seed=seed, host_id=host_id,
              num_hosts=num_hosts, step=step)
    t, j = TokenPipeline(**kw), JTokenPipeline(**kw)
    for _ in range(3):
        bt, bj = t.next_batch(), j.next_batch()
        assert bt.keys() == bj.keys()
        for k in bj:
            assert bt[k].dtype == bj[k].dtype and bt[k].tobytes() == bj[k].tobytes()
    assert t.state() == j.state()
    t.restore((seed, step + 1))
    j.restore((seed, step + 1))
    assert t.next_batch()["tokens"].tobytes() == j.next_batch()["tokens"].tobytes()


def _jax_state(jcfg):
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    opt = JAdamW()
    st = opt.init(pj)
    # a second moment that is not zero, in the params' tree
    st = st._replace(step=jnp.asarray(4, jnp.int32),
                     nu=jax.tree.map(lambda p: jnp.square(p.astype(jnp.float32)), pj))
    return (pj, st, (3, 17))


def _port_template(tcfg, device="cpu"):
    params = _params(tcfg, seed=9)
    return (params, AdamW().init(params), (0, 0))


def test_jax_checkpoint_restores_bit_for_bit_in_the_port(tmp_path):
    jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jstate = _jax_state(jcfg)
    jckpt.save(str(tmp_path), 7, jstate, cfg=jcfg)
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        keys = json.load(f)["keys"]
    assert "0/blocks/wq" in keys and "1/mu/embed" in keys and "1/step" in keys
    state, step = ckpt.restore(str(tmp_path), _port_template(tcfg), cfg=tcfg)
    assert step == 7 and state[2] == (3, 17)
    assert state[0]["embed"].dtype == torch.bfloat16 and state[1].step.dtype == torch.int32
    flat_j = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(
        (jstate[0], jstate[1].mu, jstate[1].nu))}
    port = (state[0], state[1].mu, state[1].nu)
    flat_t = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(port)}
    assert flat_j.keys() == flat_t.keys()
    for k, v in flat_j.items():
        np.testing.assert_array_equal(_bits(flat_t[k]), _bits(v), err_msg=k)
    assert int(state[1].step) == 4


def test_port_checkpoint_restores_bit_for_bit_in_jax(tmp_path):
    jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
    params = _params(tcfg, seed=5)
    opt = AdamW()
    st = opt.init(params)
    st = st._replace(step=torch.tensor(2, dtype=torch.int32),
                     mu=jax.tree.map(lambda p: p.float() * 0.5, params))
    ckpt.save(str(tmp_path), 2, (params, st, (1, 2)), cfg=tcfg)
    template = _jax_state(jcfg)
    (pj, sj, pipe), step = jckpt.restore(str(tmp_path), template, cfg=jcfg)
    assert step == 2 and tuple(int(x) for x in pipe) == (1, 2) and int(sj.step) == 2
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_leaves_with_path((pj, sj.mu, sj.nu))}
    want = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path((params, st.mu, st.nu))}
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_config_hash_equal_in_both_packages(arch):
    assert ckpt.config_hash(get_config(arch)) == jckpt.config_hash(j_config(arch))
    assert ckpt.config_hash(get_smoke_config(arch)) == jckpt.config_hash(j_smoke(arch))


def test_converted_params_cross_through_a_checkpoint(tmp_path):
    """Weights converted from JAX (``convert.lm_params_from_numpy``) save
    the same keys and bits as the JAX tree."""
    jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    pt = convert.lm_params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    jckpt.save(str(tmp_path / "j"), 1, pj, cfg=jcfg)
    ckpt.save(str(tmp_path / "t"), 1, pt, cfg=tcfg)
    zj = np.load(tmp_path / "j" / "step_00000001" / "shard_0.npz")
    zt = np.load(tmp_path / "t" / "step_00000001" / "shard_0.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype and zj[k].tobytes() == zt[k].tobytes(), k
    mj = json.loads((tmp_path / "j" / "step_00000001" / "manifest.json").read_text())
    mt = json.loads((tmp_path / "t" / "step_00000001" / "manifest.json").read_text())
    assert mj == mt
