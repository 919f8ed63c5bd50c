"""SLO policies: how long the micro-batcher may hold an open batch (a copy
of ``repro/serving/policy.py``).

The batching window is the one knob that trades tail latency for engine
occupancy.  A policy maps *observed queue depth* to the window for the
currently-open batch; the server re-asks it on every submit, so a policy
sees depth changes immediately and the deadline of the open batch moves
with it (the batcher derives the deadline from the oldest pending
request's submit time plus the current window).
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable


@runtime_checkable
class SLOPolicy(Protocol):
    """Maps observed queue depth to a batching window in milliseconds."""

    def window_ms(self, queue_depth: int) -> float: ...


@dataclasses.dataclass
class FixedWindow:
    """Always wait up to ``max_wait_ms`` — the baseline policy."""

    max_wait_ms: float

    def window_ms(self, queue_depth: int) -> float:
        return self.max_wait_ms


@dataclasses.dataclass
class AdaptiveWindow:
    """Shrink the window linearly as the queue fills.

    At depth 0 a lone request waits the full ``max_wait_ms`` hoping for
    company; at depth >= ``max_batch`` the next flush is already full, so
    waiting only adds latency — the window collapses to ``min_wait_ms``.
    This is the standard load-adaptive micro-batching rule (deep queue ⇒
    batches fill on their own ⇒ stop paying the latency budget).
    """

    max_wait_ms: float
    max_batch: int
    min_wait_ms: float = 0.0

    def window_ms(self, queue_depth: int) -> float:
        if self.max_batch <= 0:
            return self.max_wait_ms
        frac = min(queue_depth / self.max_batch, 1.0)
        w = self.max_wait_ms * (1.0 - frac)
        return max(self.min_wait_ms, min(w, self.max_wait_ms))
