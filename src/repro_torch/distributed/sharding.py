"""Sharding layout for the distributed SGL solver.

Counterpart of ``repro/distributed/sharding.py``.  The design matrix X
(n, G, ng) shards rows over "data" (and "pod") and feature groups over
"model":

    X     : rows over dp, groups over "model"
    y     : rows over dp
    beta  : groups over "model", replicated over data
    resid : rows over dp

Each entry maps an array dimension to the mesh dimensions it is sharded
over, in order (``()`` = replicated along that array dimension), where the
reference writes a ``PartitionSpec``.  Per FISTA step each rank holds an
(n_loc, G_loc, ng) block; the gradient X^T resid needs only a sum over the
data axes; the dual-norm max is a collective max of one scalar per model
shard; the residual update sums the partial products over the model axis.
Screening is local per group shard.
"""
from __future__ import annotations

__all__ = ["sgl_specs"]


def sgl_specs(multi_pod: bool = False) -> dict:
    dp = ("pod", "data") if multi_pod else ("data",)
    return {
        "X": (dp, ("model",), ()),
        "y": (dp,),
        "beta": (("model",), ()),
        "w": (("model",),),
        "Lg": (("model",),),
        "feat_mask": (("model",), ()),
        "resid": (dp,),
    }
