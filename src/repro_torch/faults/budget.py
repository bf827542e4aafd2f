"""Per-request solve budgets: deadlines + epoch caps, checked at
host-synced round boundaries.

Counterpart of ``repro/faults/budget.py``.  A :class:`SolveBudget` is
attached to an :class:`~repro_torch.core.session.SGLSession`
(``session.budget``) for the duration of one request.  The solver checks it
only where it already reads a value back from the device (the
``float(gap)`` after every certified round, and between path lambdas), so
budgets add no device round-trips.  A tripped budget never invents an
answer: the solve returns the prefix it actually certified, with the last
certified full-problem gap — the serving layer surfaces that as a typed
:class:`~repro_torch.faults.errors.Degraded`.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

__all__ = ["SolveBudget"]


class SolveBudget:
    """Monotonic deadline + total-epoch cap for one request.

    ``deadline_s`` is relative to construction time (the moment the
    server starts serving the request); ``max_epochs`` caps the total BCD
    epochs across every lambda of the path.  ``clock`` is injectable for
    deterministic tests.
    """

    def __init__(self, deadline_s: Optional[float] = None,
                 max_epochs: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        if deadline_s is None and max_epochs is None:
            raise ValueError("a SolveBudget needs a deadline_s and/or "
                             "max_epochs")
        self._clock = clock
        self._deadline = (clock() + float(deadline_s)
                          if deadline_s is not None else None)
        self.max_epochs = int(max_epochs) if max_epochs is not None else None
        self.epochs = 0

    def note_epochs(self, n: int) -> None:
        self.epochs += int(n)

    def exceeded(self) -> Optional[str]:
        """The trip reason ("deadline" | "epoch_budget"), or None."""
        if self._deadline is not None and self._clock() > self._deadline:
            return "deadline"
        if self.max_epochs is not None and self.epochs >= self.max_epochs:
            return "epoch_budget"
        return None
