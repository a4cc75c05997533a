"""The port's rewrite rules O1 and O2 against the JAX package's, on the CPU.

On every workload (scale 0.3) each O1/O2 rule enumerates the JAX rule's
configs in the same order; applying each config gives the JAX package's
plan (same signature) and the JAX package's result at the ``.canonical()``
bar (rtol=atol=5e-4, int columns and row sets exact). ``ALL_RULES``
registers o1-o4 in the JAX package's order. ``tests/test_rules.py`` is
ported on the same representative query built in both packages: every
rule's first configs, coverage, the chained split and pushdown, fuse and
unfuse, and seeded random rule sequences (the hypothesis form of the last
is in ``test_torch_rules_properties.py``).
"""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import executor as jex, ir as jir
from repro.core.rules import ALL_RULES as J_RULES
from repro.data import workloads as jwl
from repro.mlfuncs import builders as jbuilders
from repro.mlfuncs.registry import Registry as JRegistry
from repro.relational.table import Table as JTable
from repro_torch import convert
from repro_torch.core import executor, ir
from repro_torch.core.rules import ALL_RULES
from repro_torch.data import workloads as twl
from repro_torch.mlfuncs import builders
from repro_torch.mlfuncs.registry import Registry
from repro_torch.relational.table import Table
from repro_torch.testing import assert_canonical_close

SCALE = 0.3
NAMES = sorted(jwl.ALL_WORKLOADS)
O1_O2 = ("R1-1", "R1-2", "R1-3", "R1-4-merge", "R1-4-split", "compact", "R2-1", "R2-3")


def _key(cfg):
    """A config with its backend names mapped to the port's."""
    return cfg.rule, tuple((k, convert.backend(v) if k == "backend" else v)
                           for k, v in cfg.params)


def port_signature(s: str) -> str:
    """A JAX plan signature with its backend names mapped to the port's."""
    return re.sub(r"\bpallas\b", "kernel", re.sub(r"\bjnp\b", "torch", s))


def sync_fresh_names():
    """Both packages number the columns their rewrites create from one
    process-wide counter each; start them level so that equal rewrites
    give equal signatures."""
    from repro.core.rules import base as jbase
    from repro_torch.core.rules import base
    jbase._fresh_counter[0] = base._fresh_counter[0] = 0


@functools.lru_cache(maxsize=None)
def _pair(name):
    jw = jwl.ALL_WORKLOADS[name](scale=SCALE)
    return jw, twl.ALL_WORKLOADS[name](scale=SCALE, device="cpu")


def test_rule_registry_matches_jax():
    assert list(ALL_RULES) == list(J_RULES)
    from repro.core import mcts as jmcts
    from repro_torch.core import mcts
    assert mcts.ACTION_SPACE == jmcts.ACTION_SPACE


@pytest.mark.parametrize("rule", O1_O2)
@pytest.mark.parametrize("name", NAMES)
def test_o1_o2_rules_match_jax(name, rule):
    jw, tw = _pair(name)
    jcfgs = J_RULES[rule].configs(jw.plan, jw.catalog)
    tcfgs = ALL_RULES[rule].configs(tw.plan, tw.catalog)
    assert [_key(c) for c in tcfgs] == [_key(c) for c in jcfgs]
    for jc, tc in zip(jcfgs, tcfgs):
        jplan = J_RULES[rule].apply(jw.plan, jw.catalog, jc)
        tplan = ALL_RULES[rule].apply(tw.plan, tw.catalog, tc)
        label = f"{name}/{rule} {dict(tc.params)}"
        assert tplan.signature() == port_signature(jplan.signature()), label
        want = jex.execute(jplan, jw.catalog).canonical()
        got = executor.execute(tplan, tw.catalog, device="cpu").canonical()
        assert_canonical_close(want, got, label)


def test_compact_rule_counts_on_the_catalog_device(monkeypatch):
    """The compact rule's count runs on the device of the catalog's tables
    (here the CPU, with no CUDA in reach) and is cached on the catalog."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tw = twl.retail_q2(scale=SCALE, device="cpu")
    first = ALL_RULES["compact"].configs(tw.plan, tw.catalog)
    assert first and tw.catalog._compact_rule_counts
    assert [_key(c) for c in ALL_RULES["compact"].configs(tw.plan, tw.catalog)] == \
        [_key(c) for c in first]


def test_compact_rule_raises_what_is_not_a_missing_bound(monkeypatch):
    """A failure of the count other than an operand or size refusal (here
    a stand-in for a CUDA error) raises instead of dropping the config."""
    tw = twl.retail_q2(scale=SCALE, device="cpu")

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(executor, "execute", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ALL_RULES["compact"].configs(tw.plan, tw.catalog)

    def refused(*a, **kw):
        raise ValueError("operands the kernel refuses")

    monkeypatch.setattr(executor, "execute", refused)
    tw = twl.retail_q2(scale=SCALE, device="cpu")
    ALL_RULES["compact"].configs(tw.plan, tw.catalog)  # no bound, no config
    assert None in tw.catalog._compact_rule_counts.values()


# ---------------------------------------------------------------------------
# tests/test_rules.py's representative query, in both packages
# ---------------------------------------------------------------------------

def _query(table, catalog_cls, registry_cls, builders_mod, irm):
    rng = np.random.default_rng(0)
    n, m = 40, 16
    users = table({"user_id": np.arange(n, dtype=np.int32),
                   "age": np.asarray(rng.integers(18, 80, n), np.float32),
                   "user_f": np.asarray(rng.standard_normal((n, 12)), np.float32)})
    movies = table({"movie_id": np.arange(m, dtype=np.int32),
                    "genre": np.asarray(rng.integers(0, 5, m), np.int32),
                    "movie_f": np.asarray(rng.standard_normal((m, 8)), np.float32)})
    cat = catalog_cls()
    cat.add("users", users)
    cat.add("movies", movies)
    reg = registry_cls()
    reg.register(builders_mod.two_tower("tt", [12, 16, 8], [8, 16, 8], seed=1))
    trend = builders_mod.ffnn("trend", [8, 8, 1], seed=2)
    trend.selectivity_hint = 0.5
    reg.register(trend)
    reg.register(builders_mod.concat_ffnn("cf", [12, 8], [16, 1], seed=3))
    reg.register(builders_mod.decision_forest("forest", 6, 3, 12, seed=4))
    reg.register(builders_mod.autoencoder_encoder("ae", 12, 4096, 4, seed=5))
    reg.register(builders_mod.kmeans_assign("km", 4, 12, seed=6))
    root = irm.Project(
        child=irm.Filter(
            child=irm.Filter(
                child=irm.CrossJoin(irm.Scan("users"), irm.Scan("movies")),
                pred=irm.IsIn(irm.Col("genre"), (1, 2, 3))),
            pred=irm.Cmp(">", irm.Call("trend", (irm.Col("movie_f"),)), irm.Const(0.4))),
        outputs=(("score", irm.Call("tt", (irm.Col("user_f"), irm.Col("movie_f")))),
                 ("cscore", irm.Call("cf", (irm.Col("user_f"), irm.Col("movie_f")))),
                 ("fpred", irm.Call("forest", (irm.Col("user_f"),))),
                 ("enc", irm.Call("ae", (irm.Col("user_f"),))),
                 ("cluster", irm.Call("km", (irm.Col("user_f"),)))),
        keep=("user_id", "movie_id"))
    return irm.Plan(root, reg), cat


@pytest.fixture(scope="module")
def setup():
    jplan, jcat = _query(lambda cols: JTable.from_columns(
        {k: jnp.asarray(v) for k, v in cols.items()}), jir.Catalog, JRegistry, jbuilders, jir)
    tplan, tcat = _query(lambda cols: Table.from_columns(cols, device="cpu"),
                         ir.Catalog, Registry, builders, ir)
    base = jex.execute(jplan, jcat).canonical()
    assert_canonical_close(base, executor.execute(tplan, tcat, device="cpu").canonical(),
                           "representative query")
    return (jplan, jcat), (tplan, tcat), base


@pytest.mark.parametrize("rule_name", sorted(J_RULES))
def test_rule_preserves_results(setup, rule_name):
    (jplan, jcat), (plan, cat), base = setup
    cfgs = ALL_RULES[rule_name].configs(plan, cat)
    jcfgs = J_RULES[rule_name].configs(jplan, jcat)
    assert [_key(c) for c in cfgs] == [_key(c) for c in jcfgs]
    for cfg in cfgs[:6]:
        p2 = ALL_RULES[rule_name].apply(plan, cat, cfg)
        assert_canonical_close(base, executor.execute(p2, cat, device="cpu").canonical(),
                               f"{rule_name} {dict(cfg.params)}")


def test_rules_have_coverage(setup):
    _, (plan, cat), _ = setup
    applicable = {n for n, r in ALL_RULES.items() if r.configs(plan, cat)}
    assert {"R1-1", "R1-2", "R1-4-merge", "R2-1", "R3-1", "R3-2", "R3-3",
            "R4-1-fuse", "R4-1-split", "R4-2"} <= applicable


def test_chained_split_pushdown(setup):
    """Paper Fig. 4: split two-tower, push towers below the cross join."""
    _, (plan, cat), base = setup
    for _ in range(2):
        cfgs = ALL_RULES["R4-1-split"].configs(plan, cat)
        if not cfgs:
            break
        plan = ALL_RULES["R4-1-split"].apply(plan, cat, cfgs[0])
    for rn in ["R1-2", "R1-3"]:
        for _ in range(8):
            cfgs = ALL_RULES[rn].configs(plan, cat)
            if not cfgs:
                break
            plan = ALL_RULES[rn].apply(plan, cat, cfgs[0])
    assert_canonical_close(base, executor.execute(plan, cat, device="cpu").canonical(),
                           "chained")


def test_unfuse_roundtrip(setup):
    _, (plan, cat), base = setup
    plan2 = ALL_RULES["R4-1-fuse"].apply(plan, cat, ALL_RULES["R4-1-fuse"].configs(plan, cat)[0])
    cfgs2 = ALL_RULES["R4-1-unfuse"].configs(plan2, cat)
    assert cfgs2
    plan3 = ALL_RULES["R4-1-unfuse"].apply(plan2, cat, cfgs2[0])
    assert_canonical_close(base, executor.execute(plan3, cat, device="cpu").canonical(),
                           "fuse/unfuse")


def random_rule_sequence(plan, cat, rules, seed):
    """Four seeded random rule applications (the hypothesis test's body)."""
    rng = np.random.default_rng(seed)
    names = sorted(rules)
    for _ in range(4):
        name = names[int(rng.integers(0, len(names)))]
        cfgs = rules[name].configs(plan, cat)
        if not cfgs:
            continue
        plan = rules[name].apply(plan, cat, cfgs[int(rng.integers(0, len(cfgs)))])
    return plan


@pytest.mark.parametrize("seed", range(10))
def test_random_rule_sequences_match_jax(setup, seed):
    """The same seeded rule sequence gives the JAX package's plan and
    leaves the result unchanged."""
    (jplan, jcat), (plan, cat), base = setup
    sync_fresh_names()
    jout = random_rule_sequence(jplan, jcat, J_RULES, seed)
    out = random_rule_sequence(plan, cat, ALL_RULES, seed)
    assert out.signature() == port_signature(jout.signature())
    assert_canonical_close(base, executor.execute(out, cat, device="cpu").canonical(),
                           f"seq seed={seed}")
