"""repro_torch.ckpt — atomic, digest-verified checkpoints (the reference's
on-disk format; see :mod:`repro_torch.ckpt.checkpoint`)."""
from ..faults.errors import CheckpointCorrupt
from .checkpoint import (
    CheckpointManager,
    gc_keep_k,
    latest,
    latest_step,
    quarantine_count,
    restore,
    save,
)

__all__ = ["CheckpointManager", "save", "restore", "latest", "latest_step",
           "gc_keep_k", "quarantine_count", "CheckpointCorrupt"]
