"""Background work that gives way to a backlogged server in its process.

A live index's writer and the server in front of it share one
interpreter.  Both are host-bound: while both run Python, each gets about
half of it, and a server whose engine step is mostly host time then
answers at about half the rate it has alone.  So a server that falls
behind raises the process's pressure (:func:`press`, from
:class:`~repro_torch.serving.server.AnnServer` when its queue passes two
batches) until its queue is back under one batch (:func:`release`), and
background loops (Vamana and insert rounds, prune chunks, re-prune
chunks) call :func:`yield_point` between steps: while any server presses,
it waits, at most ``max_wait_s`` at a time, so the work still moves if a
server never catches up.  Only when the work runs changes, never what it
computes; with no server in the process a yield point is one truth test.
"""

from __future__ import annotations

import threading
import time

MAX_WAIT_S = 1.0  # the longest one yield point waits

_cond = threading.Condition()
_pressing: set[int] = set()  # ids of the servers that press
_stats = {"presses": 0, "waits": 0, "wait_s": 0.0}


def press(owner) -> None:
    """``owner`` (a server) has fallen behind: background work waits."""
    with _cond:
        if id(owner) not in _pressing:
            _pressing.add(id(owner))
            _stats["presses"] += 1


def release(owner) -> None:
    """``owner`` has caught up (or stopped); a no-op if it did not
    press."""
    with _cond:
        _pressing.discard(id(owner))
        if not _pressing:
            _cond.notify_all()


def pressed() -> bool:
    return bool(_pressing)


def yield_point(max_wait_s: float = MAX_WAIT_S) -> float:
    """Wait while a server in the process presses, at most ``max_wait_s``;
    returns the seconds waited (0.0 at once when none presses)."""
    if not _pressing:
        return 0.0
    t0 = time.perf_counter()
    with _cond:
        _cond.wait_for(lambda: not _pressing, timeout=max_wait_s)
        waited = time.perf_counter() - t0
        _stats["waits"] += 1
        _stats["wait_s"] += waited
    return waited


def stats() -> dict:
    """``presses`` (a server starting to press), ``waits`` (yield points
    that found one pressing) and ``wait_s`` (their seconds), since the
    process started or :func:`reset_stats`."""
    with _cond:
        return dict(_stats)


def reset_stats() -> None:
    with _cond:
        _stats.update(presses=0, waits=0, wait_s=0.0)
