"""Deterministic fault plans: which fault, where, and on which hit.

Counterpart of ``repro/faults/plan.py``.  A :class:`FaultSpec` names an
injection *site* (a registered host-level hook — see :data:`SITES`), a
fault *kind*, and a firing *schedule*: the 0-based hit indices at that site
on which the fault fires.  Sites count hits per
:func:`repro_torch.faults.inject.inject` activation, so a plan is a pure
value — replaying the same plan against the same workload fires the same
faults at the same program points.

``seed`` feeds the only randomness any injector uses (bit-flip offsets),
so even the "random" corruption is deterministic per plan.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

__all__ = ["FaultSpec", "FaultPlan", "KINDS", "SITES"]

# Fault kinds an injector can dispatch on.
KINDS = (
    "nan",          # multiply the targeted numeric payload by NaN
    "inf",          # multiply the targeted numeric payload by +inf
    "raise",        # raise a typed error at the site (kernel launch, ...)
    "stall",        # sleep stall_s at the site (drives deadline budgets)
    "kill",         # raise WorkerCrash (serve worker / mid-segment)
    "truncate",     # cut a checkpoint payload file in half
    "bitflip",      # flip one bit of a checkpoint payload file
    "poison",       # corrupt a stored certificate-store record in place
)

# Registered injection sites (host-level hooks: a fault fires at dispatch
# time, on the host, before or after a launch).  The value documents which
# kinds the site honours and what one "hit" means.
SITES = {
    "core.round": (
        "one certified full round (SGLSession._certified_round); kinds "
        "nan/inf corrupt the round's gap plus the field named by "
        "FaultSpec.field (resid | corr | theta), stall sleeps before the "
        "round"
    ),
    "core.epochs": (
        "one inner BCD epoch block in SGLSession.solve; nan/inf corrupt "
        "the iterate beta after the block"
    ),
    "kernels.screen": (
        "one certified screening-round dispatch; raise fails the launch "
        "and surfaces KernelLaunchError; there is no demotion"
    ),
    "kernels.epochs": (
        "one fused epoch-kernel dispatch (solver backend cuda, per-lambda "
        "and batched runs); raise fails the launch and surfaces "
        "KernelLaunchError; there is no demotion"
    ),
    "serve.worker": (
        "one request group entering service; kill crashes the worker's "
        "solve loop before the solve starts"
    ),
    "serve.segment": (
        "one checkpoint segment boundary inside a chunked path; kill "
        "crashes the worker mid-path (recovery resumes from the last "
        "intact checkpoint)"
    ),
    "ckpt.payload": (
        "one published checkpoint payload (arrays.npz); truncate/bitflip "
        "corrupt the file after the atomic publish, after its digest was "
        "recorded"
    ),
    "store.record": (
        "one certificate-store put; poison corrupts the stored exact "
        "record after its digest was recorded"
    ),
}


class FaultSpec(NamedTuple):
    """One addressable fault: site + kind + firing schedule."""

    site: str                    # key of SITES
    kind: str                    # member of KINDS
    hits: Tuple[int, ...] = (0,)  # 0-based hit indices that fire
    field: str = ""              # numeric target at core.round
                                 #   (resid | corr | theta; "" = theta)
    stall_s: float = 0.0         # sleep duration for kind="stall"

    def validate(self) -> "FaultSpec":
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; registered sites: "
                f"{sorted(SITES)}"
            )
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; kinds: {list(KINDS)}"
            )
        if not self.hits:
            raise ValueError("FaultSpec.hits must name at least one hit")
        if any(h < 0 for h in self.hits):
            raise ValueError(f"negative hit index in {self.hits}")
        if self.kind == "stall" and self.stall_s <= 0:
            raise ValueError("kind='stall' needs stall_s > 0")
        return self


class FaultPlan:
    """An immutable, seeded set of :class:`FaultSpec` values."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs = tuple(
            (s if isinstance(s, FaultSpec) else FaultSpec(*s)).validate()
            for s in specs
        )
        self.seed = int(seed)

    def for_site(self, site: str) -> Tuple[FaultSpec, ...]:
        return tuple(s for s in self.specs if s.site == site)

    def __repr__(self) -> str:  # stable: plans are test/report values
        inner = ", ".join(repr(s) for s in self.specs)
        return f"FaultPlan([{inner}], seed={self.seed})"
