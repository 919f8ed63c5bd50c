"""Trace-event JSON validation (a copy of ``repro/telemetry/validate.py``,
which is framework-free): the schema check every emitted trace is held to,
plus the semantic checkers of the traced serving, fleet and durability
runs.

``validate_chrome_trace`` enforces the subset of the Chrome trace-event
format this repo emits (object form with a ``traceEvents`` array; ``X``
complete events with non-negative ``dur``; ``b``/``e`` async pairs with
ids; ``i`` instants; ``M`` metadata) — enough that chrome://tracing and
Perfetto load the file, and enough that a regression in the exporter
fails CI instead of producing a silently unloadable artifact.

``check_fleet_trace`` / ``check_serving_trace`` /
``check_durability_trace`` are the *semantic* checks: the fleet trace
must show an injected preemption's kill → backoff → resume lifecycle on
worker tracks, the serving trace must decompose each sampled request's
end-to-end latency into its queue/batch/engine/rerank/resolve phases
with <5% residual, and the durability trace must show the WAL → crash →
recover → replay lifecycle the crash-injection bench drives.
"""

from __future__ import annotations

__all__ = [
    "check_durability_trace", "check_fleet_trace", "check_serving_trace",
    "validate_chrome_trace",
]

_PHASES = {"X", "B", "E", "b", "e", "n", "i", "I", "M", "C", "s", "t", "f"}


def validate_chrome_trace(obj) -> list[str]:
    """Return a list of schema violations (empty == valid)."""
    errors: list[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["missing/invalid 'traceEvents' array"]
    open_async: dict[tuple, int] = {}
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            errors.append(f"{where}: invalid ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing name")
        if ph == "M":
            continue
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), (int, str)):
                errors.append(f"{where}: missing {key}")
        if not isinstance(ev.get("ts"), (int, float)):
            errors.append(f"{where}: missing numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X event needs dur >= 0")
        if ph in ("b", "e"):
            if "id" not in ev:
                errors.append(f"{where}: async event needs an id")
            else:
                key = (ev.get("cat"), str(ev["id"]), ev["name"])
                open_async[key] = open_async.get(key, 0) + (
                    1 if ph == "b" else -1
                )
                if open_async[key] < 0:
                    errors.append(
                        f"{where}: async 'e' with no open 'b' for {key}"
                    )
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"{where}: args must be an object")
    for key, depth in open_async.items():
        if depth != 0:
            errors.append(f"unbalanced async pair {key}: depth {depth}")
    return errors


def _tracks(obj) -> dict[int, str]:
    """tid -> track name from thread_name metadata."""
    out = {}
    for ev in obj.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            out[ev["tid"]] = ev.get("args", {}).get("name", "")
    return out


def _contains(outer: dict, ts: float, tol: float = 1.0) -> bool:
    """ts (µs) falls inside an X event's [ts, ts+dur] window (±tol µs)."""
    t0 = outer["ts"] - tol
    return t0 <= ts <= outer["ts"] + outer.get("dur", 0.0) + tol


def check_fleet_trace(obj) -> dict:
    """Verify the preemption lifecycle renders on the fleet timeline.

    Requirements (matching what ``build_scalegann_fleet`` emits when a
    kill is injected):

    * ≥1 ``fleet.preempt.kill`` instant on a ``worker-*`` track, nested
      inside a ``fleet.shard_build`` attempt span on that same track;
    * ≥1 ``fleet.backoff`` span starting at/after a kill;
    * ≥1 ``fleet.resume`` span nested inside a ``fleet.shard_build``
      attempt span on a ``worker-*`` track.

    Returns a summary dict with ``ok`` plus per-condition booleans.
    """
    tracks = _tracks(obj)
    worker_tids = {t for t, n in tracks.items() if n.startswith("worker-")}
    attempts: dict[int, list[dict]] = {}
    kills: list[dict] = []
    backoffs: list[dict] = []
    resumes: list[dict] = []
    for ev in obj.get("traceEvents", []):
        name, ph = ev.get("name"), ev.get("ph")
        if name == "fleet.shard_build" and ph == "X":
            attempts.setdefault(ev["tid"], []).append(ev)
        elif name == "fleet.preempt.kill":
            kills.append(ev)
        elif name == "fleet.backoff" and ph == "X":
            backoffs.append(ev)
        elif name == "fleet.resume" and ph == "X":
            resumes.append(ev)

    kill_nested = any(
        k["tid"] in worker_tids
        and any(_contains(a, k["ts"]) for a in attempts.get(k["tid"], []))
        for k in kills
    )
    backoff_after_kill = any(
        any(b["ts"] >= k["ts"] - 1.0 for k in kills) for b in backoffs
    )
    resume_nested = any(
        r["tid"] in worker_tids
        and any(_contains(a, r["ts"]) for a in attempts.get(r["tid"], []))
        for r in resumes
    )
    summary = {
        "n_worker_tracks": len(worker_tids),
        "n_attempt_spans": sum(len(v) for v in attempts.values()),
        "n_kills": len(kills),
        "n_backoffs": len(backoffs),
        "n_resumes": len(resumes),
        "kill_nested_in_worker_attempt": kill_nested,
        "backoff_after_kill": backoff_after_kill,
        "resume_nested_in_worker_attempt": resume_nested,
    }
    summary["ok"] = bool(
        worker_tids and kill_nested and backoff_after_kill and resume_nested
    )
    return summary


def check_durability_trace(obj, min_crashes: int = 1) -> dict:
    """Verify the crash→recover lifecycle renders on the durability track.

    Requirements (matching what the WAL / snapshot / recovery paths emit
    under a crash injector):

    * ≥1 ``durability.wal_append`` span (mutations were logged);
    * ≥1 ``durability.snapshot_save`` span (a generation was committed);
    * ≥ ``min_crashes`` ``durability.crash`` instants;
    * ≥1 ``durability.recover`` span with a ``durability.replay`` span
      nested inside its time window (recovery actually replayed).

    Returns a summary dict with ``ok`` plus per-condition counts.
    """
    appends: list[dict] = []
    saves: list[dict] = []
    crashes: list[dict] = []
    recovers: list[dict] = []
    replays: list[dict] = []
    for ev in obj.get("traceEvents", []):
        name, ph = ev.get("name"), ev.get("ph")
        if ph == "X":
            if name == "durability.wal_append":
                appends.append(ev)
            elif name == "durability.snapshot_save":
                saves.append(ev)
            elif name == "durability.recover":
                recovers.append(ev)
            elif name == "durability.replay":
                replays.append(ev)
        elif name == "durability.crash":
            crashes.append(ev)
    replay_nested = any(
        any(_contains(rec, rep["ts"]) for rec in recovers)
        for rep in replays
    )
    summary = {
        "n_wal_appends": len(appends),
        "n_snapshot_saves": len(saves),
        "n_crashes": len(crashes),
        "n_recovers": len(recovers),
        "n_replays": len(replays),
        "replay_nested_in_recover": replay_nested,
    }
    summary["ok"] = bool(
        appends and saves and len(crashes) >= min_crashes
        and recovers and replay_nested
    )
    return summary


#: child phase names of one serve.request lane (emission order)
SERVING_PHASES = ("serve.queue_wait", "serve.batch", "serve.engine",
                  "serve.rerank", "serve.resolve")


def check_serving_trace(obj, min_coverage: float = 0.95) -> dict:
    """Verify per-request latency decomposition.

    For every ``serve.request`` async lane (keyed by id), the child
    phases must cover ≥ ``min_coverage`` of the request's end-to-end
    duration (child time is clipped to the parent window, so overlap
    can't fake coverage).  Zero-duration requests count as covered.

    Returns ``{ok, n_requests, n_below, min_coverage_seen, mean_coverage}``.
    """
    spans: dict[str, dict[str, list[float]]] = {}
    open_b: dict[tuple, float] = {}
    for ev in obj.get("traceEvents", []):
        ph = ev.get("ph")
        if ph not in ("b", "e") or ev.get("cat") != "serving":
            continue
        key = (str(ev["id"]), ev["name"])
        if ph == "b":
            open_b[key] = ev["ts"]
        else:
            t0 = open_b.pop(key, None)
            if t0 is None:
                continue
            spans.setdefault(str(ev["id"]), {}).setdefault(
                ev["name"], []
            ).append((t0, ev["ts"]))

    n_requests, n_below = 0, 0
    coverages: list[float] = []
    for aid, by_name in spans.items():
        reqs = by_name.get("serve.request")
        if not reqs:
            continue
        for (r0, r1) in reqs:
            n_requests += 1
            total = r1 - r0
            if total <= 0:
                coverages.append(1.0)
                continue
            covered = 0.0
            for phase in SERVING_PHASES:
                for (c0, c1) in by_name.get(phase, []):
                    covered += max(0.0, min(c1, r1) - max(c0, r0))
            cov = min(covered / total, 1.0)
            coverages.append(cov)
            if cov < min_coverage:
                n_below += 1
    return {
        "ok": bool(n_requests > 0 and n_below == 0),
        "n_requests": n_requests,
        "n_below": n_below,
        "min_coverage_seen": min(coverages) if coverages else 0.0,
        "mean_coverage": (sum(coverages) / len(coverages)) if coverages
        else 0.0,
    }
