"""Session cache: a repeat tenant rebuilds nothing.

Counterpart of ``repro/serve/cache.py``.  An
:class:`repro_torch.core.session.SGLSession` owns every expensive
per-problem artifact — the persistent transposed design, ``lam_max``, the
gather caches.  :class:`SessionCache` keeps an LRU of sessions keyed on
the problem *value* digest + the config's :meth:`SolverConfig.cache_token`,
so a repeat tenant (or a new tenant with the same problem) reuses them.

A sub-cache sharpens the miss path: ``prepare_transposed(X)`` depends only
on X, so perturbed-``y`` tenants (new problem digest, same design) adopt
the cached (p, n) copy through ``SGLSession(xt_pre=...)`` instead of
building another (``design_hits`` counts these).

The reference's retrace watch (jit-cache growth on a cache hit) has no
counterpart: PyTorch keeps no compiled-program cache to grow.  What a hit
must not rebuild — the transposed design, ``lam_max`` — is held by the
session itself.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch

from ..core.session import SGLSession, SolverConfig, _problem_to
from ..core.sgl import SGLProblem
from ..core.solver import resolve_backend
from ..kernels import ops as kops
from ..kernels._util import resolve_device
from ..losses import resolve_loss
from ..obs import metrics as obs_metrics
from .types import ProblemKeys, problem_keys

__all__ = ["SessionCache"]

_CACHE_COUNTERS = {
    "hits": "Session-cache hits (a built session reused)",
    "misses": "Session-cache misses (fresh session built)",
    "evictions": "Sessions evicted by the LRU capacity bound",
    "design_hits": "Transposed-design sub-cache hits across tenants",
    "loss_rejects": "Cache hits refused for a mismatched loss (collision)",
}
for _k, _h in _CACHE_COUNTERS.items():
    obs_metrics.declare("serve.cache_" + _k, "counter", _h)


def _counter_attr(key: str):
    """Int-attribute view of a registry counter (``self.hits += 1`` and
    plain reads work while the number lives on the registry)."""

    def _get(self) -> int:
        return self._m[key].value

    def _set(self, v: int) -> None:
        self._m[key]._set(int(v))

    return property(_get, _set, doc=_CACHE_COUNTERS[key])


class SessionCache:
    """LRU of :class:`SGLSession` objects on ``device``, value-keyed.

    ``capacity=0`` disables caching (every lookup is a miss and nothing is
    retained — the shared transposed-design sub-cache is bypassed too).
    ``device``: where the sessions run, the card unless named.
    """

    def __init__(self, capacity: int = 8, design_capacity: int = 8,
                 device=None):
        self.capacity = int(capacity)
        self.design_capacity = int(design_capacity)
        self.device = resolve_device(device)
        self._sessions: "OrderedDict[tuple, SGLSession]" = OrderedDict()
        self._designs: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        self.metrics = obs_metrics.MetricsRegistry()
        self._m = {k: self.metrics.counter("serve.cache_" + k)
                   for k in _CACHE_COUNTERS}

    hits = _counter_attr("hits")
    misses = _counter_attr("misses")
    evictions = _counter_attr("evictions")
    design_hits = _counter_attr("design_hits")
    loss_rejects = _counter_attr("loss_rejects")

    # -- lookups -----------------------------------------------------------

    def key(self, problem: SGLProblem, config: SolverConfig,
            keys: Optional[ProblemKeys] = None) -> tuple:
        """``keys``: the request's digests when the caller holds them (the
        server does), else they are computed here."""
        if keys is None:
            keys = problem_keys(problem, config)
        return (keys.problem, config.cache_token())

    def get(self, problem: SGLProblem, config: SolverConfig,
            keys: Optional[ProblemKeys] = None) -> "tuple[SGLSession, bool]":
        """``(session, hit)`` — builds (and caches) a session on a miss."""
        if keys is None:
            keys = problem_keys(problem, config)
        key = self.key(problem, config, keys)
        sess = self._sessions.get(key)
        if sess is not None:
            if repr(sess.loss) != repr(resolve_loss(config.loss)):
                # The key already hashes the loss (via cache_token), so a
                # hit with another loss means the keying regressed: refuse
                # to hand a tenant a session of another data fidelity.
                self.loss_rejects += 1
                raise RuntimeError(
                    f"session-cache key collision across losses: cached "
                    f"session solves {sess.loss.name!r}, request asks "
                    f"for {resolve_loss(config.loss).name!r}"
                )
            self._sessions.move_to_end(key)
            self.hits += 1
            return sess, True
        self.misses += 1
        sess = self._build(problem, config, keys.x)
        if self.capacity > 0:
            self._sessions[key] = sess
            while len(self._sessions) > self.capacity:
                self._sessions.popitem(last=False)
                self.evictions += 1
        return sess, False

    def _build(self, problem: SGLProblem, config: SolverConfig,
               dkey: str) -> SGLSession:
        if problem.device != self.device:
            problem = _problem_to(problem, self.device)
        xt_pre = None
        needs_xt = "cuda" in (
            resolve_backend(config.screen_backend, self.device),
            resolve_backend(config.solver_backend, self.device))
        # capacity=0 means fully cold: no design reuse either.
        if needs_xt and self.capacity > 0 and self.design_capacity > 0:
            xt_pre = self._designs.get(dkey)
            if xt_pre is not None:
                self._designs.move_to_end(dkey)
                self.design_hits += 1
            else:
                xt_pre = kops.prepare_transposed(problem.X)
                self._designs[dkey] = xt_pre
                while len(self._designs) > self.design_capacity:
                    self._designs.popitem(last=False)
        return SGLSession(problem, config, device=self.device, xt_pre=xt_pre)

    # -- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        return {
            "sessions": len(self._sessions),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "design_hits": self.design_hits,
            "loss_rejects": self.loss_rejects,
        }
