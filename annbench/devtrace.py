"""Reading the device trace of a traced window: what ran on the card and
when (``torch.profiler`` over CUDA activity), its union as busy time, the
idle gaps between, and what the host was doing in each gap, from the spans
of the program's tracer and of the harness."""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def profiled(on: bool):
    """``torch.profiler`` over the card's activity while the block runs;
    yields the profiler, or None when ``on`` is false."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof


def device_events(prof) -> list:
    """``(name, start_ns, end_ns)`` of every operation the card ran, on
    the host's wall clock (``time.time_ns``), sorted by start."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        s = e.start_ns()
        out.append((e.name(), s, s + max(e.duration_ns(), 0)))
    out.sort(key=lambda t: t[1])
    return out


def busy_intervals(events: list, t0: int, t1: int) -> list:
    """The union of the events' intervals within ``[t0, t1]``."""
    merged: list = []
    for _, s, e in events:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_gaps(busy: list, t0: int, t1: int) -> list:
    gaps, at = [], t0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if t1 > at:
        gaps.append((at, t1))
    return gaps


def tracer_spans(tracer, wall_minus_clock_ns: int) -> list:
    """``(name, start_ns, end_ns)`` of a tracer's finished spans on the
    host's wall clock, given the wall clock minus the tracer's clock."""
    chrome = tracer.to_chrome()
    out = []
    for ev in chrome["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        s = int((tracer.epoch + ev["ts"] / 1e6) * 1e9) + wall_minus_clock_ns
        out.append((ev["name"], s, s + int(ev["dur"] * 1e3)))
    return out


def label_gaps(gaps: list, spans: list) -> dict:
    """Idle seconds by the innermost span open at each gap's middle
    (``"no span"`` where none was)."""
    by: dict = {}
    spans = sorted(spans, key=lambda t: t[1])
    active: list = []
    i = 0
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (s + e) // 2
        while i < len(spans) and spans[i][1] <= mid:
            active.append(spans[i])
            i += 1
        active = [sp for sp in active if sp[2] > mid]
        inner = min(active, key=lambda sp: sp[2] - sp[1]) if active else None
        key = inner[0] if inner else "no span"
        by[key] = by.get(key, 0.0) + (e - s) / 1e9
    return by


def summarize(prof, t0: int, t1: int, spans: list) -> dict:
    """``busy_s``, ``window_s``, the top device operations and the idle
    seconds by host span over ``[t0, t1]`` (wall-clock ns)."""
    events = device_events(prof)
    busy = busy_intervals(events, t0, t1)
    ops: dict = {}
    for name, s, e in events:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
    idle = label_gaps(idle_gaps(busy, t0, t1), spans)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "n_events": len(events),
        "beam_kernels": sum(1 for n, s, e in events
                            if "beam_kernel" in n and t0 <= s < t1),
        "device_ops": [[n[:120], v] for n, v in top],
        "idle_gaps": [[n[:120], v] for n, v in gaps],
    }


def wall_minus_monotonic_ns() -> int:
    return time.time_ns() - time.monotonic_ns()
