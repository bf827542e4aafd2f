"""Model zoo dispatch: family -> implementation module.

Counterpart of ``repro/models/__init__.py``: the same eight
:class:`ModelAPI` fields and family dispatch.  ``init_params(generator=None,
dtype=torch.bfloat16, device=None)`` returns the model as an ``nn.Module``
(the card unless ``device`` names another; with no GPU this raises), drawn
from an explicit ``torch.Generator`` at the reference's init scales;
``forward``, ``prefill`` and ``decode_step`` take that module where the
reference takes its parameter tree.  ``param_specs`` and ``cache_specs``
give the reference's logical spec trees.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

from . import encdec, rglru, ssm, transformer


class ModelAPI(NamedTuple):
    cfg: Any
    init_params: Callable
    param_specs: Callable      # (model_axis) -> spec tree
    forward: Callable          # (params, tokens, embeds=None) -> (logits, aux)
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    cache_specs: Callable


_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": ssm,
    "hybrid": rglru,
    "encdec": encdec,
}


def build(cfg) -> ModelAPI:
    mod = _FAMILY_MODULES[cfg.family]
    return ModelAPI(
        cfg=cfg,
        init_params=functools.partial(mod.init_params, cfg),
        param_specs=functools.partial(mod.param_specs, cfg),
        forward=functools.partial(mod.forward, cfg),
        prefill=functools.partial(mod.prefill, cfg),
        decode_step=functools.partial(mod.decode_step, cfg),
        init_cache=functools.partial(mod.init_cache, cfg),
        cache_specs=functools.partial(mod.cache_specs, cfg),
    )


__all__ = ["build", "ModelAPI", "transformer", "ssm", "rglru", "encdec"]
