"""Warm-start + certificate store: prior paths accelerate re-solves.

Counterpart of ``repro/serve/store.py``.  A solve of a *nearby* problem —
perturbed ``y``, a refined lambda grid — is warm almost everywhere, so
starting it from a stored path's primal points turns most tenant traffic
into a handful of epochs per lambda (paper §7.1's sequential regime).

Safety contract: **stored state warm-starts, it never certifies.**  A
:class:`WarmHint` hands back only a primal point ``beta`` (plus provenance);
the stored masks and gaps ride along as diagnostics but are never returned
as active-set masks, never injected as a ``first_round``, and never
intersected into anything.  Every discard reported for the new solve comes
from a fresh GAP round evaluated on the NEW problem at the NEW lambda —
:meth:`SGLSession.solve_path` re-screens from ``beta0`` before any epoch.
(A GAP sphere from *any* feasible primal/dual pair is safe — Thm 1/2 —
which is why warm-starting the primal point is free while reusing masks
would not be.)

Admission is measured, not assumed: :func:`warm_eval` computes the duality
gap of a candidate hint on the new problem, and the server adopts the hint
only when that gap beats the cold start's.

Exact repeats short-circuit entirely: the store keeps the full
:class:`PathResult` keyed by request digest, so an identical re-request is
served from memory without touching the solver.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import sgl
from ..core.session import PathResult, SolverConfig
from ..core.sgl import SGLProblem
from ..faults.inject import fire as _fire_fault
from ..losses import resolve_loss
from .types import ProblemKeys, array_digest, problem_keys

__all__ = ["CertificateStore", "PathRecord", "WarmHint", "warm_eval"]


def _result_digest(result: PathResult) -> str:
    """Content digest of a stored exact result's payload arrays.

    Recorded at put() time and re-checked at exact() time, so a record
    that rots in place (bit-flip, or an injected ``store.record`` poison)
    can never be served verbatim — the entry is dropped and the request
    falls through to a fresh solve.
    """
    parts = (np.asarray(result.lambdas), np.asarray(result.betas),
             np.asarray(result.gaps), np.asarray(result.epochs))
    h = hashlib.blake2b(digest_size=16)
    for a in parts:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def warm_eval(problem: SGLProblem, beta, lam_, loss=None) -> torch.Tensor:
    """Duality gap of a warm-start candidate on the NEW problem, on the
    problem's device.

    One O(n p) pass: the residual at ``beta``, the dual-scaled feasible
    point (Eq. 15), gap = primal - dual.  The server compares this against
    the cold start's gap to decide admission — the hint is adopted as a
    primal point only, so this is an economics decision, not a safety
    decision (safety comes from the fresh GAP rounds inside the solve).
    ``loss=None`` is the squared loss; a :class:`repro_torch.losses.Loss`
    evaluates the same gap from ``rho = -grad F(X beta)`` and the loss's
    conjugate dual.
    """
    X = problem.X
    beta = torch.as_tensor(beta, dtype=X.dtype).to(X.device)
    lam_ = float(lam_)
    if loss is None or loss.name == "lsq":
        resid = problem.y - torch.einsum("ngk,gk->n", X, beta)
        corr = torch.einsum("ngk,n->gk", X, resid)
        scale = torch.clamp(sgl.sgl_dual_norm(corr, problem.tau, problem.w),
                            min=lam_)
        theta = resid / scale
        pr = (0.5 * (resid * resid).sum()
              + lam_ * sgl.sgl_norm(beta, problem.tau, problem.w))
        return pr - sgl.dual(problem, theta, lam_)
    z = torch.einsum("ngk,gk->n", X, beta)
    rho = loss.neg_grad(problem.y, z)
    corr = torch.einsum("ngk,n->gk", X, rho)
    scale = torch.clamp(sgl.sgl_dual_norm(corr, problem.tau, problem.w),
                        min=lam_)
    theta = rho / scale
    pr = (loss.value(problem.y, z)
          + lam_ * sgl.sgl_norm(beta, problem.tau, problem.w))
    return pr - loss.dual_obj(problem.y, theta, lam_)


class PathRecord(NamedTuple):
    """Stored path state for one (design, y, grid) solve.

    ``group_active`` is provenance/diagnostics only — see the module
    docstring's safety contract; nothing downstream may adopt it as a
    certificate for a different problem.
    """

    lambdas: np.ndarray          # (T,) grid, largest first
    betas: np.ndarray            # (T, G, ng) primal points (the hints)
    gaps: np.ndarray             # (T,) certified gaps on the SOURCE problem
    epochs: np.ndarray           # (T,)
    group_active: np.ndarray     # (T, G) masks of the SOURCE problem
    certificates_safe: bool
    y_digest: str
    loss_token: str = "LeastSquaresLoss()"
                                 # repr of the loss the path was solved
                                 #   under; a primal point optimised for a
                                 #   different data fidelity must never be
                                 #   offered as a hint (defense-in-depth —
                                 #   the design digest already separates
                                 #   losses via the config cache token)


class WarmHint(NamedTuple):
    """A candidate primal warm start (never a certificate)."""

    beta: np.ndarray             # (G, ng) stored primal point
    lam_src: float               # grid point the hint was solved at
    same_y: bool                 # hint comes from the identical y
    record: PathRecord


class CertificateStore:
    """LRU store of solved paths: exact-repeat results + warm-start hints.

    ``capacity`` bounds both maps (entries, not bytes — records hold
    (T, G, ng) arrays, so size the capacity to the problem scale).
    ``capacity=0`` disables the store entirely (baseline mode).
    """

    def __init__(self, capacity: int = 32):
        self.capacity = int(capacity)
        self._exact: OrderedDict[str, PathResult] = OrderedDict()
        self._exact_digests: "OrderedDict[str, str]" = OrderedDict()
        self._records: OrderedDict[tuple, PathRecord] = OrderedDict()
        self.exact_hits = 0
        self.warm_hits = 0
        self.puts = 0
        self.evictions = 0
        self.loss_rejects = 0
        self.poison_drops = 0

    # -- writes ------------------------------------------------------------

    def put(self, request_digest: str, problem: SGLProblem,
            config: SolverConfig, result: PathResult, *,
            exact: bool = True,
            keys: Optional[ProblemKeys] = None) -> None:
        """Record a solved path.  ``exact=False`` skips the exact-repeat
        map and keeps only the warm-start record — used for merged-grid
        slices, which match the request's solo output to solver tolerance
        rather than bit-exactly and so must never satisfy the verbatim
        exact-repeat short-circuit.  ``keys``: the problem's digests when
        the caller holds them, else they are computed here."""
        if self.capacity <= 0:
            return
        self.puts += 1
        if exact:
            self._exact[request_digest] = result
            self._exact.move_to_end(request_digest)
            self._exact_digests[request_digest] = _result_digest(result)
            self._exact_digests.move_to_end(request_digest)
            # Chaos hook: post-storage bit-rot — the poison lands AFTER
            # the digest was recorded, so verification must catch it.
            for s in _fire_fault("store.record"):
                if s.kind == "poison":
                    bad = np.array(result.betas, copy=True)
                    if bad.size:
                        bad.flat[0] += 1.0
                    self._exact[request_digest] = result._replace(
                        betas=bad
                    )
        if keys is None:
            keys = problem_keys(problem, config)
        dkey, ydig = keys.design, keys.y
        rkey = (dkey, ydig, array_digest(np.asarray(result.lambdas)))
        self._records[rkey] = PathRecord(
            lambdas=np.asarray(result.lambdas),
            betas=np.asarray(result.betas),
            gaps=np.asarray(result.gaps),
            epochs=np.asarray(result.epochs),
            group_active=np.asarray(result.group_active),
            certificates_safe=bool(result.certificates_safe),
            y_digest=ydig,
            loss_token=repr(resolve_loss(config.loss)),
        )
        self._records.move_to_end(rkey)
        while len(self._exact) > self.capacity:
            dig, _ = self._exact.popitem(last=False)
            self._exact_digests.pop(dig, None)
            self.evictions += 1
        while len(self._records) > self.capacity:
            self._records.popitem(last=False)
            self.evictions += 1

    # -- reads -------------------------------------------------------------

    def exact(self, request_digest: str) -> Optional[PathResult]:
        """The stored result of an identical earlier request, or None.

        Integrity-checked: the entry's payload digest (recorded at put
        time) is re-verified before serving.  A mismatch means the record
        rotted in place — the entry is dropped (``poison_drops``) and the
        caller falls through to a fresh solve instead of serving
        corrupted betas verbatim.
        """
        res = self._exact.get(request_digest)
        if res is None:
            return None
        want = self._exact_digests.get(request_digest)
        if want is not None and _result_digest(res) != want:
            del self._exact[request_digest]
            del self._exact_digests[request_digest]
            self.poison_drops += 1
            return None
        self._exact.move_to_end(request_digest)
        self.exact_hits += 1
        return res

    def warm_hint(self, problem: SGLProblem, config: SolverConfig,
                  lambdas: np.ndarray,
                  keys: Optional[ProblemKeys] = None) -> Optional[WarmHint]:
        """Best stored primal point for a solve of ``problem`` starting at
        ``lambdas[0]`` — same-design records only, same-``y`` preferred,
        nearest stored lambda (in log space) to the new path's start.
        ``keys`` as in :meth:`put`."""
        if keys is None:
            keys = problem_keys(problem, config)
        dkey, ydig = keys.design, keys.y
        loss_token = repr(resolve_loss(config.loss))
        candidates = []
        for k, r in self._records.items():
            if k[0] != dkey:
                continue
            if r.loss_token != loss_token:
                # Should be unreachable (the design digest hashes the
                # config cache token, loss included) — counted, never
                # served: a hint optimised under another data fidelity is
                # an anti-warm start at best.
                self.loss_rejects += 1
                continue
            candidates.append((k, r))
        if not candidates:
            return None
        same = [(k, r) for k, r in candidates if r.y_digest == ydig]
        pool = same if same else candidates
        lam0 = float(np.asarray(lambdas, float)[0])
        best = None
        for key, rec in pool:
            d = np.abs(np.log(np.maximum(rec.lambdas, 1e-300))
                       - np.log(max(lam0, 1e-300)))
            i = int(np.argmin(d))
            if best is None or d[i] < best[0]:
                best = (d[i], key, rec, i)
        _, key, rec, i = best
        self._records.move_to_end(key)
        self.warm_hits += 1
        return WarmHint(
            beta=rec.betas[i],
            lam_src=float(rec.lambdas[i]),
            same_y=rec.y_digest == ydig,
            record=rec,
        )

    # -- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        return {
            "records": len(self._records),
            "exact_entries": len(self._exact),
            "capacity": self.capacity,
            "exact_hits": self.exact_hits,
            "warm_hits": self.warm_hits,
            "puts": self.puts,
            "evictions": self.evictions,
            "loss_rejects": self.loss_rejects,
            "poison_drops": self.poison_drops,
        }


# ----------------------------------------------------------------------------
# Static-analysis registration: the entry points the dispatch lints run
# (repro_torch.analysis.registry is a leaf import — no cycle).  Each name
# pairs with a template in repro_torch.analysis.entrypoints.
# ----------------------------------------------------------------------------

from ..analysis.registry import register_traceable  # noqa: E402

register_traceable("serve_warm_eval", warm_eval, module=__name__)
