"""Hierarchical span tracer with Chrome/Perfetto trace-event export (a
copy of ``repro/telemetry/trace.py``, which is framework-free: under a
:class:`ManualClock` the same calls export byte-equal JSON).

One :class:`Tracer` records a whole run — a build (partition → shard
builds → merge, with the kernels' ``nvcc`` builds on the ``jit`` track)
or a serving session (submit → queue → batch flush → engine dispatch →
re-rank → future resolution) — onto named **tracks** that render as rows
on a single timeline in ``chrome://tracing`` / https://ui.perfetto.dev.

Design rules, in priority order:

* **Disabled is free.**  The default recorder is :data:`NULL_TRACER`
  (``enabled=False``); hot paths gate their telemetry on one
  ``if tracer.enabled`` branch and pay *nothing* else — no allocation,
  no clock read (the tests pin zero allocations on the serving hot-path
  pattern).
* **Deterministic under a fake clock.**  The clock is injectable
  (:class:`ManualClock`); span ids, track ids and export ordering are all
  derived from call order, so the same call sequence produces the same
  bytes — span trees are diffable test fixtures, not flaky logs.
* **Thread-safe.**  Spans opened on different threads interleave freely;
  the open-span stack is thread-local, the event log append is locked.

Track resolution for a new span/event: explicit ``track=`` argument,
else the innermost *open* span's track on this thread, else a per-thread
default (``thread/<name>``).  Nesting in the Chrome export is by time
containment per track, exactly how the viewers render it; explicit
``parent`` span ids are additionally recorded in ``args`` for validators.

Two extra surfaces the span stack can't express:

* :meth:`Tracer.async_complete` — Chrome *async* (``ph: b/e``) event
  pairs keyed by an id, for overlapping request flows: every served
  request gets its own ``serve.request`` lane keyed by request id, with
  queue/batch/engine/rerank child phases under it.
* :func:`record_stage` / :func:`collect_stages` — a thread-local stage
  accumulator that lets a deep callee (the exact re-rank epilogue inside
  a backend driver) report a duration to whoever is timing the enclosing
  call, without threading a tracer through every signature.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Callable

__all__ = [
    "ManualClock", "NullTracer", "NULL_SPAN", "NULL_TRACER", "Span", "Tracer",
    "collect_stages", "current_tracer", "record_stage", "set_tracer",
    "use_tracer",
]


class ManualClock:
    """A deterministic fake clock: call it for the time, ``advance`` it
    explicitly.  Injected into :class:`Tracer` (and the serving layer's
    ``clock=``) so span trees are byte-stable across runs."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


class Span:
    """One open span — a context manager handed out by :meth:`Tracer.span`.

    ``set(**args)`` attaches labels while the span is open; an exception
    propagating through the span records ``error=<type name>`` and never
    swallows it.
    """

    __slots__ = ("_tracer", "name", "track", "args", "t0", "sid", "parent")

    def __init__(self, tracer: "Tracer", name: str, track: str | None,
                 args: dict):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self.t0 = 0.0
        self.sid = -1
        self.parent = -1

    def set(self, **args: Any) -> "Span":
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack()
        if self.track is None:
            self.track = stack[-1].track if stack else tr._thread_track()
        self.parent = stack[-1].sid if stack else -1
        self.sid = next(tr._ids)
        self.t0 = tr._clock()
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        tr = self._tracer
        t1 = tr._clock()
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        tr._append(self.name, "X", self.track, self.t0, t1 - self.t0,
                   self.args, sid=self.sid, parent=self.parent)


class _NullSpan:
    """The reusable do-nothing span (singleton — never allocates): what a
    gated call site enters instead of ``tracer.span(...)`` when
    ``tracer.enabled`` is false, so the untraced path calls no tracer
    method."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **args: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled recorder: every method is a no-op returning shared
    singletons.  Hot paths should still gate on :attr:`enabled` so they
    skip even the method call (and any kwargs allocation) entirely."""

    enabled = False

    def now(self) -> float:
        return 0.0

    def span(self, *a: Any, **kw: Any) -> _NullSpan:
        return NULL_SPAN

    def instant(self, *a: Any, **kw: Any) -> None:
        return None

    def annotate(self, **args: Any) -> None:
        return None

    def complete(self, *a: Any, **kw: Any) -> None:
        return None

    def async_complete(self, *a: Any, **kw: Any) -> None:
        return None

    def to_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


NULL_TRACER = NullTracer()


class Tracer:
    """Thread-safe span/event recorder exporting Chrome trace-event JSON.

    ``clock`` must be a monotonic callable returning seconds; **every
    component feeding one tracer must share its time base** (the serving
    layer aligns its ``clock=`` with the tracer's, the kernel-build
    listener reads ``tracer.now()``).  ``max_events`` bounds memory on
    long runs —
    past it new events are dropped and counted (``otherData.dropped`` in
    the export), never blocking the traced workload.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter, *,
                 process: str = "repro", max_events: int = 2_000_000):
        self._clock = clock
        self.process = process
        self.max_events = int(max_events)
        self.epoch = clock()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._tracks: dict[str, int] = {}  # name -> tid, first-use order
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self.n_dropped = 0

    # ---- internals ------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _thread_track(self) -> str:
        return f"thread/{threading.current_thread().name}"

    def _resolve_track(self, track: str | None) -> str:
        if track is not None:
            return track
        stack = self._stack()
        return stack[-1].track if stack else self._thread_track()

    def _us(self, t: float) -> float:
        return round((t - self.epoch) * 1e6, 3)

    def _append(self, name: str, ph: str, track: str | None, t0: float,
                dur: float | None, args: dict, *, sid: int = -1,
                parent: int = -1, aid: str | None = None) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.n_dropped += 1
                return
            tid = self._tracks.setdefault(track, len(self._tracks) + 1)
            ev: dict = {
                "name": name, "ph": ph, "pid": 1, "tid": tid,
                "ts": self._us(t0), "seq": len(self._events),
            }
            if dur is not None:
                ev["dur"] = round(dur * 1e6, 3)
            if aid is not None:
                ev["id"] = aid
                ev["cat"] = args.pop("cat", "async")
            if sid >= 0:
                args = dict(args, span_id=sid, parent_id=parent)
            if args:
                ev["args"] = args
            self._events.append(ev)

    # ---- recording ------------------------------------------------------

    def now(self) -> float:
        """The tracer's clock — use this for explicit-timestamp emission
        (:meth:`complete` / :meth:`async_complete`) so all events share
        one time base."""
        return self._clock()

    def span(self, name: str, *, track: str | None = None,
             **args: Any) -> Span:
        """Open a nested span (context manager).  ``track`` pins the
        timeline row; omitted, it inherits the enclosing span's row (or a
        per-thread default)."""
        return Span(self, name, track, args)

    def instant(self, name: str, *, track: str | None = None,
                **args: Any) -> None:
        """A zero-duration marker (preemption notice, kill signal, ...)."""
        track = self._resolve_track(track)
        stack = self._stack()
        parent = stack[-1].sid if stack else -1
        self._append(name, "i", track, self._clock(), None,
                     dict(args, s="t"), sid=next(self._ids), parent=parent)

    def annotate(self, **args: Any) -> None:
        """Attach ``args`` to this thread's innermost open span (none open:
        a no-op), for a callee that labels the span its caller opened."""
        stack = self._stack()
        if stack:
            stack[-1].set(**args)

    def complete(self, name: str, t0: float, t1: float, *,
                 track: str | None = None, **args: Any) -> None:
        """Emit a finished span post-hoc from explicit ``tracer.now()``
        readings — for call sites that can't wrap their body in a
        ``with`` (per-round build telemetry, backoff windows)."""
        track = self._resolve_track(track)
        stack = self._stack()
        parent = stack[-1].sid if stack else -1
        self._append(name, "X", track, t0, max(t1 - t0, 0.0), dict(args),
                     sid=next(self._ids), parent=parent)

    def async_complete(self, name: str, aid: Any, t0: float, t1: float, *,
                       cat: str = "async", track: str = "async",
                       **args: Any) -> None:
        """One finished phase of an async flow: a Chrome ``b``/``e`` event
        pair keyed by ``aid``.  Flows with the same id nest by emission
        order — emit the parent phase first, children inside.  This is
        how overlapping per-request lanes render without fighting over
        one synchronous track."""
        a = dict(args, cat=cat)
        self._append(name, "b", track, t0, None, a, aid=str(aid))
        self._append(name, "e", track, t1, None, {"cat": cat},
                     aid=str(aid))

    # ---- export ---------------------------------------------------------

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (``traceEvents`` array form,
        loadable by chrome://tracing and Perfetto)."""
        with self._lock:
            events = [dict(e) for e in self._events]
            tracks = dict(self._tracks)
            dropped = self.n_dropped
        meta: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": self.process},
        }]
        for track, tid in tracks.items():
            meta.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                "args": {"name": track},
            })
        events.sort(key=lambda e: (e["ts"], e["seq"]))
        for e in events:
            del e["seq"]
        out = {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"clock": "seconds-since-epoch-of-tracer",
                          "dropped": dropped},
        }
        return out

    def to_json(self, *, indent: int | None = None) -> str:
        """Deterministic serialization of :meth:`to_chrome` (sorted keys —
        the byte-stability contract the tests pin)."""
        return json.dumps(self.to_chrome(), sort_keys=True, indent=indent)

    def write(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


# ---- the process-wide current tracer ------------------------------------
#
# A plain module global (not a contextvar): build workers and serving
# executor threads must see the tracer the driving thread installed, and
# contextvars don't cross thread-pool boundaries.  ``use_tracer`` is for
# the single-driver cases (scripts, tests); code that owns its own tracer
# (AnnServer) takes it as a parameter and only *defaults* to the global.

_current: NullTracer | Tracer = NULL_TRACER
_current_lock = threading.Lock()


def current_tracer() -> Tracer | NullTracer:
    """The process-wide tracer (``NULL_TRACER`` unless one is installed)."""
    return _current


def set_tracer(tracer: Tracer | NullTracer | None) -> Tracer | NullTracer:
    """Install ``tracer`` as the process-wide tracer; returns the previous
    one.  ``None`` restores the no-op recorder."""
    global _current
    with _current_lock:
        prev = _current
        _current = NULL_TRACER if tracer is None else tracer
    return prev


class use_tracer:
    """``with use_tracer(tracer): ...`` — install process-wide, restore on
    exit.  Reentrant-safe for the nested case (inner wins while open)."""

    def __init__(self, tracer: Tracer | NullTracer | None):
        self.tracer = tracer
        self._prev: Tracer | NullTracer | None = None

    def __enter__(self) -> Tracer | NullTracer:
        self._prev = set_tracer(self.tracer)
        return current_tracer()

    def __exit__(self, *exc) -> None:
        set_tracer(self._prev)


# ---- stage accumulation --------------------------------------------------

_stage_tls = threading.local()


def record_stage(name: str, seconds: float) -> None:
    """Report a stage duration to the innermost active
    :func:`collect_stages` on this thread (no-op when none is active).

    Lets a deep callee — the exact-f32 re-rank epilogue inside a search
    driver — surface its share of an enclosing timed call without every
    signature in between growing a telemetry parameter."""
    sink = getattr(_stage_tls, "sink", None)
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + float(seconds)


class collect_stages:
    """``with collect_stages() as stages: ...`` — capture
    :func:`record_stage` reports made on this thread inside the block.
    ``stages`` is a plain ``{name: seconds}`` dict."""

    def __enter__(self) -> dict:
        self._prev = getattr(_stage_tls, "sink", None)
        self.stages: dict[str, float] = {}
        _stage_tls.sink = self.stages
        return self.stages

    def __exit__(self, *exc) -> None:
        _stage_tls.sink = self._prev


def stage_active() -> bool:
    """True when a :func:`collect_stages` block is open on this thread —
    lets a callee skip even the clock reads when nobody is listening."""
    return getattr(_stage_tls, "sink", None) is not None
