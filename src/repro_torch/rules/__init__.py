"""Pluggable screening-rule strategies (counterpart of ``repro.rules``).

This slice registers the GAP safe rule (``"gap"``) and the unscreened
baseline (``"none"``)."""
from .base import RuleState, ScreeningRule
from .library import GapSafeRule, NoScreening
from .registry import available_rules, get_rule, register_rule, resolve_rule

__all__ = [
    "RuleState",
    "ScreeningRule",
    "GapSafeRule",
    "NoScreening",
    "available_rules",
    "get_rule",
    "register_rule",
    "resolve_rule",
]

register_rule(GapSafeRule())
register_rule(NoScreening())
