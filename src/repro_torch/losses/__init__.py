"""Pluggable data-fidelity losses (counterpart of ``repro.losses``): least
squares, logistic, and the multi-task math."""
from .base import Loss
from .library import LeastSquaresLoss, LogisticLoss, MultiTaskLoss
from .registry import available_losses, get_loss, register_loss, resolve_loss

__all__ = [
    "Loss",
    "LeastSquaresLoss",
    "LogisticLoss",
    "MultiTaskLoss",
    "available_losses",
    "get_loss",
    "register_loss",
    "resolve_loss",
]

register_loss(LeastSquaresLoss())
register_loss(LogisticLoss())
register_loss(MultiTaskLoss())
