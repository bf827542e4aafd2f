"""The paper's own workload: Sparse-Group Lasso at production scale.

The port's copy of ``repro/configs/sgl_paper.py``.

Used by the SGL distributed dry-run (`launch/dryrun.py --arch sgl-paper`):
the distributed FISTA + GAP-screening step lowered on the production mesh,
with the climate problem scaled up (rows = samples over `data`, feature
groups over `model`).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SGLConfig:
    name: str = "sgl-paper"
    n_samples: int = 262_144         # rows (sharded over data axis)
    n_groups: int = 262_144          # feature groups (sharded over model axis)
    group_size: int = 8              # padded group size (paper: 7-10)
    tau: float = 0.4                 # paper's cross-validated tau*
    dtype: str = "float32"


CONFIG = SGLConfig()
