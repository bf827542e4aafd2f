"""Request/response types and value digests for the serving layer.

Counterpart of ``repro/serve/types.py``.  Everything the serving layer keys
on is a *value* digest, not an object identity: two tenants submitting
numerically identical problems must land on the same cached session, the
same stored path and the same coalesced batch even though their tensors
are distinct buffers.

Three nested identities, coarse to fine:

* **compat signature** (:func:`compat_signature`) — shape, group layout,
  dtype, tau, and the :meth:`SolverConfig.cache_token` statics; the
  coalescing *compatibility* test.
* **design digest** (:func:`design_digest`) — compat signature plus the
  bytes of X and w.  Perturbed-``y`` re-solves share it; the certificate
  store and the shared transposed-design cache key on it.
* **problem digest** (:func:`problem_digest`) — design digest plus the
  bytes of y; the session cache keys on it, and adding the lambda grid
  (:meth:`PathRequest.digest`) identifies a whole request.

A digest hashes the values' host bytes: a tensor on the card is copied to
the host first (at the climate width, 479 MB of design per digest of X).
So the server hashes each request's arrays once, when it is submitted
(:func:`problem_keys`, held by the queue's pending entry), and hands the
resulting :class:`ProblemKeys` to the queue, cache, store and breaker; the
keys are still values, computed per request, never memoised on an
object's identity.
The digests equal the reference package's, character for character, on
the same values: dtypes are written as numpy names them.  The seconds
spent in :func:`array_digest` are the histogram ``serve.digest_s``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.session import PathResult, SolverConfig
from ..core.sgl import SGLProblem
from ..obs.metrics import REGISTRY

__all__ = [
    "array_digest",
    "compat_signature",
    "design_digest",
    "problem_digest",
    "problem_keys",
    "ProblemKeys",
    "PathRequest",
    "PathResponse",
]

_M_DIGEST_S = REGISTRY.histogram(
    "serve.digest_s",
    help="Seconds per array_digest call: the device-to-host copy of the "
         "values plus the blake2b over their bytes")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def array_digest(x) -> str:
    """Stable value digest of an array or tensor: blake2b over shape +
    numpy dtype name + C-contiguous bytes (16 hex chars)."""
    t0 = time.perf_counter()
    a = np.ascontiguousarray(_host(x))
    h = hashlib.blake2b(digest_size=8)
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(a)              # the bytes of a.tobytes(), without the copy
    out = h.hexdigest()
    _M_DIGEST_S.observe(time.perf_counter() - t0)
    return out


class CompatSignature(NamedTuple):
    """Coalescing-compatibility key: same (n, p, group layout, tau, dtype)
    and the same solver statics."""

    n: int
    G: int
    ng: int
    layout: str          # feat_mask value digest (the group layout)
    dtype: str           # numpy's name ("float64")
    tau: float
    statics: tuple       # SolverConfig.cache_token()


def compat_signature(problem: SGLProblem,
                     config: SolverConfig) -> CompatSignature:
    return CompatSignature(
        n=problem.n, G=problem.G, ng=problem.ng,
        layout=array_digest(problem.feat_mask),
        dtype=str(np.dtype(str(problem.X.dtype).replace("torch.", ""))),
        tau=float(problem.tau),
        statics=config.cache_token(),
    )


def _chain(*parts: str) -> str:
    h = hashlib.blake2b(digest_size=8)
    for part in parts:
        h.update(part.encode())
    return h.hexdigest()


class ProblemKeys(NamedTuple):
    """Every value identity of one request, each array hashed once."""

    compat: CompatSignature
    x: str                   # array_digest(X): the transposed-design key
    design: str              # design_digest
    y: str                   # array_digest(y)
    problem: str             # problem_digest
    request: Optional[str]   # PathRequest.digest; None without a grid


def problem_keys(problem: SGLProblem, config: SolverConfig,
                 lambdas=None) -> ProblemKeys:
    """The digests of :func:`design_digest`, :func:`problem_digest` and
    :meth:`PathRequest.digest` (when ``lambdas`` is given), with X, w, y
    and the group layout each hashed once."""
    compat = compat_signature(problem, config)
    x = array_digest(problem.X)
    design = _chain(repr(compat), x, array_digest(problem.w))
    y = array_digest(problem.y)
    prob = _chain(design, y)
    request = (None if lambdas is None else
               _chain(prob, array_digest(np.asarray(lambdas, float))))
    return ProblemKeys(compat, x, design, y, prob, request)


def design_digest(problem: SGLProblem, config: SolverConfig) -> str:
    """Identity of the design side of a problem (everything but y)."""
    return problem_keys(problem, config).design


def problem_digest(problem: SGLProblem, config: SolverConfig) -> str:
    return problem_keys(problem, config).problem


@dataclasses.dataclass
class PathRequest:
    """One tenant's lambda-path solve.

    ``lambdas`` is the explicit grid (largest first); ``config`` defaults
    to the server's default config.  ``warm_start`` opts this request out
    of certificate-store warm starts (the stored hints are safe either
    way — the flag exists for A/B measurement).
    """

    tenant: str
    problem: SGLProblem
    lambdas: Sequence[float]
    config: Optional[SolverConfig] = None
    warm_start: bool = True

    def resolved_config(self, default: SolverConfig) -> SolverConfig:
        return self.config if self.config is not None else default

    def grid(self) -> np.ndarray:
        return np.asarray(self.lambdas, float)

    def digest(self, default_config: SolverConfig) -> str:
        """Full request identity: problem + grid + config statics (tenant
        excluded — identical requests from different tenants coalesce)."""
        return self.keys(default_config).request

    def keys(self, default_config: SolverConfig) -> ProblemKeys:
        """Every digest of this request (see :func:`problem_keys`)."""
        return problem_keys(self.problem,
                            self.resolved_config(default_config),
                            self.grid())


@dataclasses.dataclass
class PathResponse:
    """A solved path plus serving metadata.

    ``result.certificates_safe`` reflects the screening rule that actually
    ran, never a stored certificate (stored state warm-starts, it never
    certifies — see :mod:`repro_torch.serve.store`).
    """

    tenant: str
    request_digest: str
    result: PathResult
    served_from: str         # "solve" | "store" | "coalesced"
    coalesced_n: int = 1     # requests served by the same path solve
    session_cache_hit: bool = False
    store_hit: bool = False
    warm_started: bool = False
    warm_source_lam: Optional[float] = None
    resumed_from: Optional[int] = None   # lambda cursor a resume started at
    merged_grid: bool = False
    queue_s: float = 0.0
    solve_s: float = 0.0
