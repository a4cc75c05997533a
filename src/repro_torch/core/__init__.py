"""Logical IR, evaluator, physical operators, lowering and execution."""
