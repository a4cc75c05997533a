"""Co-optimization rules O1-O4 (paper Sec. II-A + Appendix A).

Every rule is result-preserving: applying any of its configs leaves the
plan's canonical output unchanged. ``ALL_RULES`` holds them in the JAX
package's registration order (o1, o2, o3, o4), which the search's random
choices walk.
"""
from repro_torch.core import ir
from repro_torch.core.rules.base import Rule, RuleConfig, ALL_RULES, rule_by_name
from repro_torch.core.rules import o1, o2, o3, o4  # noqa: F401  (registration side effects)

__all__ = ["Rule", "RuleConfig", "ALL_RULES", "rule_by_name", "kernel_plan"]

# (rules, which of their configs) in the order kernel_plan applies them
_KERNEL_STEPS = (
    (("R3-1", "R3-2"), lambda cfg, original: cfg.get("fn") in original),
    (("R4-2",), lambda cfg, original: cfg.get("kind") == "mode"),
    (("R4-2",), lambda cfg, original: (cfg.get("kind") == "node"
                                       and cfg.get("backend") == "kernel")),
    (("R4-1-fuse",), lambda cfg, original: True),
    (("R4-2",), lambda cfg, original: (cfg.get("kind") == "atom"
                                       and cfg.get("backend") == "kernel")),
)


def kernel_plan(plan: ir.Plan, catalog: ir.Catalog) -> ir.Plan:
    """Rewrite ``plan`` so that what the O3/O4 rules can reach runs on the
    hand-written kernels, in five steps:

    1. R3-1 on the first matmul of each call of a registered function, and
       R3-2 on each forest call (calls of functions that earlier rewrites
       created are left alone);
    2. R4-2 ``mode`` -> fused on each BlockedMatmul / ForestRelational;
    3. R4-2 ``node`` -> kernel on each of them;
    4. R4-1-fuse on each matmul -> bias -> act chain;
    5. R4-2 ``atom`` -> kernel on each fused_dense and forest atom.

    One config at a time: configs are enumerated anew after each rewrite,
    because a rewrite makes the paths of the others stale.
    """
    original = frozenset(plan.registry)
    for names, wanted in _KERNEL_STEPS:
        while True:
            hit = next(((ALL_RULES[n], cfg) for n in names
                        for cfg in ALL_RULES[n].configs(plan, catalog)
                        if wanted(cfg, original)), None)
            if hit is None:
                break
            plan = hit[0].apply(plan, catalog, hit[1])
    return plan
