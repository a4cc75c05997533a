"""Random rule sequences never change the port's results (hypothesis form
of ``test_torch_rules.py::test_random_rule_sequences_match_jax``, as
``tests/test_rules.py`` guards its own)."""
import pytest

pytest.importorskip("hypothesis")  # property tests degrade to skips
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import executor  # noqa: E402
from repro_torch.core.rules import ALL_RULES  # noqa: E402
from repro_torch.testing import assert_canonical_close  # noqa: E402

from test_torch_rules import _query, random_rule_sequence  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    from repro_torch.core import ir
    from repro_torch.mlfuncs import builders
    from repro_torch.mlfuncs.registry import Registry
    from repro_torch.relational.table import Table
    plan, cat = _query(lambda cols: Table.from_columns(cols, device="cpu"),
                       ir.Catalog, Registry, builders, ir)
    return plan, cat, executor.execute(plan, cat, device="cpu").canonical()


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_prop_random_rule_sequences(setup, seed):
    plan, cat, base = setup
    out = random_rule_sequence(plan, cat, ALL_RULES, seed)
    assert_canonical_close(base, executor.execute(out, cat, device="cpu").canonical(),
                           f"seq seed={seed}")
