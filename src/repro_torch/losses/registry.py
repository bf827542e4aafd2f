"""Name -> :class:`Loss` registry (counterpart of
``repro/losses/registry.py``).  Unknown names fail fast with the registered
list."""
from __future__ import annotations

from typing import Dict, List, Union

from .base import Loss

__all__ = ["available_losses", "get_loss", "register_loss", "resolve_loss"]

_REGISTRY: Dict[str, Loss] = {}


def register_loss(loss: Loss, *, overwrite: bool = False) -> Loss:
    """Register ``loss`` under ``loss.name``; re-registering a name needs
    ``overwrite=True``."""
    if not isinstance(loss, Loss):
        raise TypeError(f"expected a Loss instance, got {loss!r}")
    if loss.name in _REGISTRY and not overwrite:
        raise ValueError(f"loss {loss.name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    _REGISTRY[loss.name] = loss
    return loss


def available_losses() -> List[str]:
    return sorted(_REGISTRY)


def get_loss(name: str) -> Loss:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; registered losses: "
                         f"{available_losses()}") from None


def resolve_loss(loss: Union[str, Loss]) -> Loss:
    """A registered name or a loss object -> the loss object."""
    if isinstance(loss, Loss):
        return loss
    if isinstance(loss, str):
        return get_loss(loss)
    raise TypeError(f"loss must be a registered name or a Loss, got {loss!r}")
