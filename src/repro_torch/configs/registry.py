"""Architecture registry: --arch <id> resolution.

The port's copy of ``repro/configs/registry.py`` (it imports nothing of
``repro``); the names, the pruned set and the messages are the reference's,
with the module path of this package.

Pruned to the configs this repository actually solves with: the paper's
own workload (``sgl-paper``) and a tiny dense LM (``demo``) for the
model-zoo smoke paths.  The seed-era LLM zoo configs (qwen*,
llama3-405b, mixtral-8x7b, ...) were scaffolding from the repository
template — no production code path imported them — and were removed;
:func:`get` keeps erroring helpfully on their names so stale scripts
fail with directions instead of an ImportError.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "sgl-paper",
    "demo",
]

_MODULES = {
    "sgl-paper": "sgl_paper",
}

# Seed-era LLM zoo configs removed in the configs prune.  Kept as a name
# set purely for the error message below.
_REMOVED = frozenset({
    "qwen2.5-14b",
    "codeqwen1.5-7b",
    "qwen3-8b",
    "llama3-405b",
    "recurrentgemma-2b",
    "olmoe-1b-7b",
    "mixtral-8x7b",
    "mamba2-2.7b",
    "seamless-m4t-large-v2",
    "llava-next-mistral-7b",
})


def get(name: str):
    if name == "demo":
        from .base import DEMO

        return DEMO
    if name in _REMOVED:
        raise KeyError(
            f"arch {name!r} was removed in the configs prune (the "
            f"seed-era LLM zoo was template scaffolding); use 'demo' for "
            f"a tiny dense LM, 'sgl-paper' for the paper workload, or "
            f"construct an ArchConfig directly via repro_torch.configs.base"
        )
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"{__package__}.{_MODULES[name]}")
    return mod.CONFIG


def list_archs():
    return list(ARCH_IDS)
