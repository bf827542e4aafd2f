"""Pluggable screening-rule strategies (counterpart of ``repro.rules``): the
paper's Fig. 2/3 family — GAP safe, static, dynamic, DST3, no screening and
the unsafe strong rule — sharing one sphere-test skeleton."""
from .base import RuleState, ScreeningRule
from .library import (
    Dst3Rule,
    DynamicSafeRule,
    GapSafeRule,
    NoScreening,
    StaticSafeRule,
    StrongSequentialRule,
)
from .registry import available_rules, get_rule, register_rule, resolve_rule

__all__ = [
    "RuleState",
    "ScreeningRule",
    "GapSafeRule",
    "StaticSafeRule",
    "DynamicSafeRule",
    "Dst3Rule",
    "NoScreening",
    "StrongSequentialRule",
    "available_rules",
    "get_rule",
    "register_rule",
    "resolve_rule",
]

register_rule(GapSafeRule())
register_rule(StaticSafeRule())
register_rule(DynamicSafeRule())
register_rule(Dst3Rule())
register_rule(NoScreening())
register_rule(StrongSequentialRule())
