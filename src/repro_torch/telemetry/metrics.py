"""Metrics registry: counters, gauges and reservoir histograms with
Prometheus text exposition and a JSON snapshot (a copy of
``repro/telemetry/metrics.py``, which is framework-free: the same
operations give byte-equal exposition text and equal quantiles).

This is the *numeric* half of the telemetry subsystem (spans are the
*temporal* half, :mod:`repro_torch.telemetry.trace`): the serving stats,
the kernel-build listener and the build drivers feed one
:class:`MetricsRegistry` instead of each growing private ad-hoc counters,
and anything that can read Prometheus text or JSON can scrape the result.

Semantics follow the Prometheus data model:

* **Counter** — monotonically non-decreasing ``inc``-only total.
* **Gauge** — ``set``/``inc``/``dec``-able point-in-time value.
* **Histogram** — ``observe``-ed samples kept three ways: cumulative
  ``le``-bucket counts (the Prometheus exposition), exact count/sum, and
  a bounded uniform **reservoir** (seeded, deterministic under a fixed
  observation order) for JSON-side quantiles — a long-running server's
  percentiles stay O(1) memory, same trade the serving stats have always
  made.

Families are keyed by metric name; children by their label values.  A
family's label *names* are fixed at first use (mixing label sets under
one name is a modeling bug and raises).  All mutation is locked — build
workers and the serving worker feed registries from pool threads.
"""

from __future__ import annotations

import random
import re
import threading
from typing import Any

__all__ = [
    "Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram", "MetricsRegistry",
    "current_registry", "parse_prometheus", "set_registry", "use_registry",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# latency-in-seconds oriented default; callers with other units pass their
# own (e.g. batch occupancy uses power-of-two buckets)
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: tuple[tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class Counter:
    """Monotonic total.  ``inc`` accepts floats — padding-scaled distance
    accounting stays exact."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counters only go up (inc {v!r})")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Cumulative-bucket histogram + bounded seeded reservoir.

    The buckets feed the Prometheus exposition; the reservoir feeds
    :meth:`percentile` / the JSON snapshot (uniform reservoir sampling
    past ``reservoir`` samples, ``random.Random(0)`` — deterministic
    under a fixed observation order, the contract the serving latency
    stats carry)."""

    __slots__ = ("_lock", "buckets", "_bucket_counts", "count", "total",
                 "_cap", "_reservoir", "_rng")

    def __init__(self, lock: threading.Lock, buckets=DEFAULT_BUCKETS,
                 reservoir: int = 10_000):
        self._lock = lock
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self.count = 0
        self.total = 0.0
        self._cap = int(reservoir)
        self._reservoir: list[float] = []
        self._rng = random.Random(0)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            i = 0
            for i, b in enumerate(self.buckets):
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            self._bucket_counts[i] += 1
            if len(self._reservoir) < self._cap:
                self._reservoir.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self._reservoir[j] = v

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """``(le, cumulative_count)`` pairs, ``+Inf`` last."""
        out, acc = [], 0
        with self._lock:
            counts = list(self._bucket_counts)
            bounds = self.buckets + (float("inf"),)
        for b, c in zip(bounds, counts):
            acc += c
            out.append((b, acc))
        return out

    def percentile(self, q: float) -> float:
        """Reservoir quantile, ``q`` in [0, 100].  0.0 when empty."""
        with self._lock:
            if not self._reservoir:
                return 0.0
            s = sorted(self._reservoir)
        if len(s) == 1:
            return s[0]
        pos = (q / 100.0) * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (pos - lo)

    def summary(self, scale: float = 1.0) -> dict:
        """p50/p95/p99/mean/max of the reservoir, scaled (e.g. 1e3 for
        ms) — the shape the serving snapshot has always exposed."""
        with self._lock:
            res = list(self._reservoir)
            count, total = self.count, self.total
        if not res:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0,
                    "max": 0.0}
        return {
            "p50": self.percentile(50) * scale,
            "p95": self.percentile(95) * scale,
            "p99": self.percentile(99) * scale,
            "mean": (total / count) * scale,
            "max": max(res) * scale,
        }

    @property
    def sum(self) -> float:
        return self.total


class _Family:
    __slots__ = ("name", "help", "kind", "label_names", "children", "kwargs")

    def __init__(self, name: str, help_: str, kind: str,
                 label_names: tuple[str, ...], kwargs: dict):
        self.name = name
        self.help = help_
        self.kind = kind
        self.label_names = label_names
        self.children: dict[tuple[str, ...], Any] = {}
        self.kwargs = kwargs


class MetricsRegistry:
    """Get-or-create metric families; every child handle is cached, so hot
    paths fetch their handle once and pay only the ``inc``/``observe``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    # ---- creation -------------------------------------------------------

    def _child(self, kind: str, ctor, name: str, help_: str,
               labels: dict[str, Any], kwargs: dict | None = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        lnames = tuple(sorted(labels))
        lvalues = tuple(str(labels[k]) for k in lnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(
                    name, help_, kind, lnames, kwargs or {}
                )
            if fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}"
                )
            if fam.label_names != lnames:
                raise ValueError(
                    f"metric {name!r} uses labels {fam.label_names}, "
                    f"got {lnames}"
                )
            child = fam.children.get(lvalues)
            if child is None:
                child = fam.children[lvalues] = ctor()
            return child

    def counter(self, name: str, help: str = "", **labels: Any) -> Counter:
        return self._child("counter", lambda: Counter(self._lock), name,
                           help, labels)

    def gauge(self, name: str, help: str = "", **labels: Any) -> Gauge:
        return self._child("gauge", lambda: Gauge(self._lock), name, help,
                           labels)

    def histogram(self, name: str, help: str = "", *,
                  buckets=DEFAULT_BUCKETS, reservoir: int = 10_000,
                  **labels: Any) -> Histogram:
        return self._child(
            "histogram",
            lambda: Histogram(self._lock, buckets, reservoir),
            name, help, labels,
            {"buckets": tuple(buckets), "reservoir": reservoir},
        )

    # ---- reading --------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready dump: ``{name: {type, help, series: [...]}}`` with
        deterministic series order (sorted label values)."""
        out: dict = {}
        with self._lock:
            fams = list(self._families.values())
        for fam in sorted(fams, key=lambda f: f.name):
            series = []
            for lvalues in sorted(fam.children):
                child = fam.children[lvalues]
                labels = dict(zip(fam.label_names, lvalues))
                if fam.kind == "histogram":
                    series.append({
                        "labels": labels,
                        "count": child.count,
                        "sum": child.total,
                        "summary": child.summary(),
                    })
                else:
                    series.append({"labels": labels, "value": child.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": series}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4 — one block per family
        (``# HELP`` / ``# TYPE`` then the samples).  Round-trips through
        :func:`parse_prometheus` (tested)."""
        lines: list[str] = []
        with self._lock:
            fams = list(self._families.values())
        for fam in sorted(fams, key=lambda f: f.name):
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for lvalues in sorted(fam.children):
                child = fam.children[lvalues]
                labels = tuple(zip(fam.label_names, lvalues))
                if fam.kind == "histogram":
                    for le, c in child.cumulative_buckets():
                        lab = _fmt_labels(labels, f'le="{_fmt_value(le)}"')
                        lines.append(f"{fam.name}_bucket{lab} {c}")
                    lab = _fmt_labels(labels)
                    lines.append(
                        f"{fam.name}_sum{lab} {_fmt_value(child.total)}"
                    )
                    lines.append(f"{fam.name}_count{lab} {child.count}")
                else:
                    lab = _fmt_labels(labels)
                    lines.append(
                        f"{fam.name}{lab} {_fmt_value(child.value)}"
                    )
        return "\n".join(lines) + "\n"


# ---- exposition parser (the round-trip check) ---------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$"
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'
)


def parse_prometheus(text: str) -> dict:
    """Parse exposition text back into ``{(name, labels_frozenset):
    value}`` — the consumer-side check that :meth:`to_prometheus` emits
    well-formed samples.  Raises on an unparseable sample line."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        labels = {}
        if m.group("labels"):
            consumed = _LABEL_PAIR_RE.findall(m.group("labels"))
            labels = {
                k: v.replace('\\"', '"').replace("\\n", "\n")
                     .replace("\\\\", "\\")
                for k, v in consumed
            }
        raw = m.group("value")
        value = float("inf") if raw == "+Inf" else (
            float("-inf") if raw == "-Inf" else float(raw))
        out[(m.group("name"), frozenset(labels.items()))] = value
    return out


# ---- the process-wide default registry ----------------------------------

_default = MetricsRegistry()
_default_lock = threading.Lock()


def current_registry() -> MetricsRegistry:
    """The process-wide registry build/search call sites feed by default
    (components that own a run — ``ServerStats`` — carry their own and
    only default to this one)."""
    return _default


def set_registry(reg: MetricsRegistry | None) -> MetricsRegistry:
    """Install ``reg`` process-wide; returns the previous registry.
    ``None`` installs a fresh empty registry."""
    global _default
    with _default_lock:
        prev = _default
        _default = MetricsRegistry() if reg is None else reg
    return prev


class use_registry:
    """``with use_registry(reg): ...`` — install process-wide, restore on
    exit, so the counters a run's workers emit land in the run's
    registry, not the global one."""

    def __init__(self, reg: MetricsRegistry | None):
        self.registry = reg
        self._prev: MetricsRegistry | None = None

    def __enter__(self) -> MetricsRegistry:
        self._prev = set_registry(self.registry)
        return current_registry()

    def __exit__(self, *exc) -> None:
        set_registry(self._prev)
