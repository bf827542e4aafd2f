"""The mesh strategy's pieces: sharding layout, compression, the sharded
FISTA and screening steps (counterpart of ``repro/distributed``)."""
from . import compression, sharding, solver_dist

__all__ = ["compression", "sharding", "solver_dist"]
