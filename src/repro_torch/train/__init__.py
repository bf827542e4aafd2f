"""LM training: AdamW, the SGL regularizer and the train step
(counterpart of ``repro/train``)."""
from . import optimizer, sgl_regularizer
from .train_step import loss_fn, make_train_step

__all__ = ["optimizer", "sgl_regularizer", "make_train_step", "loss_fn"]
