"""Kernel-build events and the engine-call signature guard (counterpart of
``repro/telemetry/jit.py``).

A first call of an engine path pays its one-time costs inside some unlucky
request's latency.  The reference's cost is a jit retrace; the port has no
jit, and its one-time costs are the ``nvcc`` build of a kernel's source and
the device copies the ``fused`` backend caches.  This module makes the
first of those a metric and the risk of all of them another:

* :func:`install_compile_listener` installs the hook that
  :func:`repro_torch.kernels._build.build_all` reports every ``nvcc`` run
  to: it increments ``kernel_builds_total{source=...}``, lands the build's
  wall time in the ``kernel_build_seconds`` histogram of the registry
  current at build time, and (when a tracer is installed) draws a
  ``kernel.build`` span on the ``jit`` track, so builds are visible on the
  same timeline as the requests they delay.
* :class:`SignatureGuard` tracks distinct engine-call signatures —
  ``(backend, batch shape, nprobe, dtype)`` in the serving worker, as in
  the reference — and flags any signature first seen *after* warm-up.  The
  serving layer feeds ``serving_post_warm_signatures_total`` from it.
"""

from __future__ import annotations

import threading
from typing import Hashable

from repro_torch.telemetry.metrics import current_registry
from repro_torch.telemetry.trace import current_tracer

__all__ = ["SignatureGuard", "install_compile_listener"]

_BUILD_BUCKETS = (0.1, 0.5, 1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0)


def _on_build(source: str, seconds: float) -> None:
    reg = current_registry()
    reg.counter(
        "kernel_builds_total", "nvcc builds of the CUDA kernels, by source",
        source=source,
    ).inc()
    reg.histogram(
        "kernel_build_seconds", "wall time of one nvcc build",
        buckets=_BUILD_BUCKETS,
    ).observe(seconds)
    tr = current_tracer()
    if tr.enabled:
        t1 = tr.now()
        tr.complete("kernel.build", t1 - seconds, t1, track="jit",
                    source=source)


def install_compile_listener() -> bool:
    """Install the kernel-build hook (idempotent — one attribute store, safe
    to call from every server/script startup).  Builds are reported to
    whatever registry/tracer is *current at build time*, so a script that
    installs its own tracer after this still captures them.  Returns True,
    as the reference does once its listener is in place."""
    from repro_torch.kernels import _build

    _build.on_build = _on_build
    return True


class SignatureGuard:
    """First-seen detector for engine-call signatures.

    ``warm(sig)`` records signatures covered by startup pretrace;
    ``observe(sig)`` returns ``(is_new, after_warmup)`` — a ``(True,
    True)`` result is the first-call risk the serving metrics count.
    Thread-safe; signatures must be hashable.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._seen: set[Hashable] = set()
        self._warmed = False

    def warm(self, sig: Hashable) -> None:
        with self._lock:
            self._seen.add(sig)

    def finish_warmup(self) -> None:
        with self._lock:
            self._warmed = True

    @property
    def n_signatures(self) -> int:
        return len(self._seen)

    def observe(self, sig: Hashable) -> tuple[bool, bool]:
        with self._lock:
            if sig in self._seen:
                return False, False
            self._seen.add(sig)
            return True, self._warmed
