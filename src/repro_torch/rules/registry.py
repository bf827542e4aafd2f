"""Name -> :class:`ScreeningRule` registry (counterpart of
``repro/rules/registry.py``).  Unknown names fail fast with the registered
list."""
from __future__ import annotations

from typing import Dict, List, Union

from .base import ScreeningRule

__all__ = ["available_rules", "get_rule", "register_rule", "resolve_rule"]

_REGISTRY: Dict[str, ScreeningRule] = {}


def register_rule(rule: ScreeningRule, *, overwrite: bool = False) -> ScreeningRule:
    """Register ``rule`` under ``rule.name``; re-registering a name needs
    ``overwrite=True``."""
    if not isinstance(rule, ScreeningRule):
        raise TypeError(f"expected a ScreeningRule instance, got {rule!r}")
    if rule.name in _REGISTRY and not overwrite:
        raise ValueError(
            f"screening rule {rule.name!r} is already registered "
            f"({_REGISTRY[rule.name]!r}); pass overwrite=True to replace it")
    _REGISTRY[rule.name] = rule
    return rule


def available_rules() -> List[str]:
    return sorted(_REGISTRY)


def get_rule(name: str) -> ScreeningRule:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown screening rule {name!r}; registered rules: "
                         f"{available_rules()}") from None


def resolve_rule(rule: Union[str, ScreeningRule]) -> ScreeningRule:
    """A registered name or a rule object -> the rule object."""
    if isinstance(rule, ScreeningRule):
        return rule
    if isinstance(rule, str):
        return get_rule(rule)
    raise TypeError(f"rule must be a registered name or a ScreeningRule, "
                    f"got {rule!r}")
