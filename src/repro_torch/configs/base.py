"""Architecture config system.

The port's copy of ``repro/configs/base.py``: the same frozen dataclasses,
field for field, so a config means the same model in both packages.

Every assigned architecture is an :class:`ArchConfig` instance in its own
``configs/<id>.py`` module; ``configs.registry.get(name)`` resolves it.  The
``reduced()`` method produces the CPU-smoke-test variant (same family / same
code paths, tiny dims).  Input shapes are :class:`ShapeSpec` entries; the 4
assigned LM shapes are defined here once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None   # sliding-window size (mixtral, local attn)
    moe: Optional[MoEConfig] = None
    # ssm / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_chunk: int = 256
    conv_width: int = 4
    hybrid_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    # enc-dec
    n_enc_layers: int = 0
    # vlm / audio stubs
    frontend_tokens: int = 0       # patch/frame embeddings prepended
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # capability flags
    subquadratic: bool = False     # can run long_500k
    notes: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        changes = dict(
            n_layers=min(self.n_layers, 2 if not self.hybrid_pattern else
                         len(self.hybrid_pattern)),
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv=min(self.n_kv, 2) if self.n_heads else 0,
            head_dim=16 if self.n_heads else None,
            d_ff=128,
            vocab=256,
            window=min(self.window, 32) if self.window else None,
            ssm_state=16 if self.ssm_state else 0,
            ssm_heads=4 if self.ssm_heads else 0,
            ssm_head_dim=16 if self.ssm_heads else 0,
            ssm_chunk=8,
            n_enc_layers=min(self.n_enc_layers, 2),
            frontend_tokens=8 if self.frontend_tokens else 0,
        )
        if self.moe is not None:
            changes["moe"] = MoEConfig(
                n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2),
                capacity_factor=self.moe.capacity_factor,
            )
        return dataclasses.replace(self, **changes)


# Tiny dense LM used by the examples/launch demo paths and the model smoke
# tests — already reduced-sized, so ``DEMO.reduced()`` is a fixed point.
DEMO = ArchConfig(
    name="demo",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    qk_norm=True,
    subquadratic=False,
    notes="tiny dense GQA config for CPU demos and smoke tests",
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in LM_SHAPES}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell is runnable; reason if not.

    long_500k needs sub-quadratic attention (DESIGN.md §Arch-applicability).
    """
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "full O(L^2) attention at 524k context — skipped by design "
            "(see DESIGN.md §Arch-applicability)"
        )
    return True, ""
