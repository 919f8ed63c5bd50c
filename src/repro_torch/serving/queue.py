"""Request queue + micro-batcher for the ANN serving front-end (a copy of
``repro/serving/queue.py``, which is framework-free).

Two layers, split so the flush semantics are testable without real time:

  * :class:`MicroBatcher` — the pure batching state machine.  No clocks, no
    asyncio: callers stamp requests with ``t_submit`` and pass ``now``
    explicitly, so a fake-clock test can prove the flush rules
    deterministically.  A batch flushes when it reaches ``max_batch``
    (size flush, on :meth:`add`) or when the *oldest* pending request has
    waited ``max_wait_s`` (deadline flush, on :meth:`poll`) — whichever
    trips first.
  * :class:`RequestQueue` — the asyncio face: bounded admission
    (reject-new or shed-oldest, both surfacing
    :class:`ServerOverloadedError`), an event the worker sleeps on, and
    ``next_batch`` which turns the batcher's deadline into a timed wait.

The deadline is *derived* (``pending[0].t_submit + max_wait_s``) rather
than stored, so an :class:`~repro_torch.serving.policy.SLOPolicy` can retune
``max_wait_s`` while a batch is open and the open batch honors the new
window immediately.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np


class ServerOverloadedError(RuntimeError):
    """The bounded request queue is full.

    Raised to the *submitter* under the ``"reject"`` admission policy, or
    set on the *oldest queued* request's future under ``"shed"`` (the new
    request is admitted in its place).
    """


@dataclasses.dataclass
class PendingRequest:
    """One in-flight single-query request."""

    query: np.ndarray  # [D] float32
    future: asyncio.Future  # resolves to a QueryResult
    t_submit: float  # clock units (seconds); queueing latency starts here
    nprobe: Any = None  # per-request routing override (NprobeSpec)
    dtype: str = "f32"  # per-request distance-stage override
    rid: int = -1  # server-assigned request id (trace lane key)
    t_flush: float = 0.0  # when the batch holding this request flushed;
    # queue wait = t_flush - t_submit (stamped by the worker)


class MicroBatcher:
    """Accumulate single requests into engine-sized batches.

    ``max_wait_s`` is mutable on purpose — the server's SLO policy updates
    it from observed queue depth, and because :meth:`deadline` derives from
    the oldest pending request, the change applies to the open batch too.
    """

    def __init__(self, max_batch: int, max_wait_s: float):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self._pending: deque[PendingRequest] = deque()

    def __len__(self) -> int:
        return len(self._pending)

    def add(self, req: PendingRequest) -> list[PendingRequest] | None:
        """Queue one request; return a full batch if this add filled one."""
        self._pending.append(req)
        if len(self._pending) >= self.max_batch:
            return self.take()
        return None

    def deadline(self) -> float | None:
        """Absolute flush time of the open batch (None when empty)."""
        if not self._pending:
            return None
        return self._pending[0].t_submit + self.max_wait_s

    def poll(self, now: float) -> list[PendingRequest] | None:
        """Deadline flush: the oldest request has waited out the window."""
        dl = self.deadline()
        if dl is not None and now >= dl:
            return self.take()
        return None

    def take(self) -> list[PendingRequest]:
        """Unconditionally flush up to ``max_batch`` oldest requests."""
        n = min(len(self._pending), self.max_batch)
        return [self._pending.popleft() for _ in range(n)]

    def shed_oldest(self) -> PendingRequest | None:
        return self._pending.popleft() if self._pending else None


class RequestQueue:
    """Bounded asyncio admission queue feeding a :class:`MicroBatcher`.

    ``depth`` counts everything admitted but not yet handed to the engine:
    requests still accumulating in the batcher plus size-flushed batches
    the worker hasn't drained yet.  Admission compares that depth against
    ``max_pending``.
    """

    def __init__(self, batcher: MicroBatcher, max_pending: int,
                 admission: str = "reject", clock=time.monotonic):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if admission not in ("reject", "shed"):
            raise ValueError(
                f"admission must be 'reject' or 'shed', got {admission!r}"
            )
        self.batcher = batcher
        self.max_pending = int(max_pending)
        self.admission = admission
        self.clock = clock
        self._ready: deque[list[PendingRequest]] = deque()
        self._event = asyncio.Event()
        self._closed = False

    def depth(self) -> int:
        return len(self.batcher) + sum(len(b) for b in self._ready)

    def submit(self, req: PendingRequest) -> PendingRequest | None:
        """Admit one request (sync, called from the event loop).

        Returns the request that was *shed* to make room, if any — its
        future has already been failed; the caller only needs it for
        accounting.  Raises :class:`ServerOverloadedError` when the queue
        is full under ``"reject"``, or :class:`RuntimeError` after
        :meth:`close`.
        """
        if self._closed:
            raise RuntimeError("server is shutting down; queue is closed")
        shed = None
        if self.depth() >= self.max_pending:
            if self.admission == "reject":
                raise ServerOverloadedError(
                    f"request queue full ({self.max_pending} pending); "
                    "retry later or raise max_pending"
                )
            shed = self._shed_oldest()
        batch = self.batcher.add(req)
        if batch is not None:
            self._ready.append(batch)
        self._event.set()
        return shed

    def _shed_oldest(self) -> PendingRequest | None:
        # size-flushed batches in _ready predate everything still open in
        # the batcher, so the globally oldest request lives at _ready[0][0]
        if self._ready:
            old = self._ready[0].pop(0)
            if not self._ready[0]:
                self._ready.popleft()
        else:
            old = self.batcher.shed_oldest()
        if old is not None and not old.future.done():
            old.future.set_exception(ServerOverloadedError(
                "request shed: the queue filled while this request waited "
                f"(max_pending={self.max_pending})"
            ))
        return old

    def close(self) -> None:
        """Stop admitting; ``next_batch`` drains what's left, then ends."""
        self._closed = True
        self._event.set()

    def fail_all(self, exc: BaseException) -> int:
        """Close and fail every admitted-but-unserved request with ``exc``
        (the worker died — a hung future would be strictly worse than an
        error).  Returns how many futures were failed."""
        self.close()
        n = 0
        batches = list(self._ready)
        self._ready.clear()
        batches.append(self.batcher.take())
        for batch in batches:
            for req in batch:
                if req.future is not None and not req.future.done():
                    req.future.set_exception(exc)
                    n += 1
        return n

    async def next_batch(self) -> list[PendingRequest] | None:
        """Await the next flushable batch (None once closed and drained).

        Priority: size-flushed batches, then a deadline flush, then sleep
        until the open batch's deadline (or the next submit, whichever
        comes first).  After :meth:`close`, whatever is pending flushes
        immediately — a clean shutdown answers every admitted request.
        """
        while True:
            if self._ready:
                return self._ready.popleft()
            if self._closed:
                return self.batcher.take() if len(self.batcher) else None
            batch = self.batcher.poll(self.clock())
            if batch is not None:
                return batch
            # no await between poll() and clear(), so no submit can slip
            # in unseen; anything later sets the event and wakes the wait
            dl = self.batcher.deadline()
            self._event.clear()
            timeout = None if dl is None else max(dl - self.clock(), 0.0)
            try:
                await asyncio.wait_for(self._event.wait(), timeout)
            except asyncio.TimeoutError:
                pass
