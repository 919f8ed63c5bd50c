"""Fault-tolerant spot-fleet build executor: the §IV scheduler driving
*real* shard builds (counterpart of ``repro/fleet/executor.py``: the same
signature, report, events, spans and ``fleet_*`` counters, with the shard
builds on the card).

``build_scalegann_fleet`` runs the paper's headline scenario end to end:
partition → per-shard ``build_shard_index_vamana`` tasks dispatched onto a
pool of worker "instances" (threads standing in for spot GPU machines) →
edge-union merge.  Unlike ``build_scalegann``'s bare thread pool, every
task here lives the spot lifecycle:

* a :class:`~repro_torch.fleet.PreemptionInjector` delivers notice/kill
  signals at round boundaries (deterministic seeded lifetimes, or
  explicit per-shard kills for tests);
* builds checkpoint at the batched-round grain through a
  :class:`~repro_torch.fleet.CheckpointStore` (serialized bytes — resume
  always crosses the serialize→deserialize boundary) and **resume
  bit-compatibly**: a preempted-and-resumed shard finishes with the same
  graph an uninterrupted build produces, so the merged index — and its
  recall — is independent of how many kills the fleet ate;
* preempted/failed tasks re-queue with capped exponential backoff and are
  re-admitted under the paper's two policies — availability-based (one
  task per live worker) and time-based (a task whose estimated remaining
  rounds exceed a noticed worker's known remaining lifetime waits for a
  healthier instance);
* task ordering and instance preference come from the same pluggable
  :class:`~repro_torch.core.scheduler.SchedulingPolicy` objects the
  virtual-clock ``Scheduler`` uses (cost-greedy vs deadline/EDD), and the
  run is priced by the calibrated §VI-C cost model (``runtime_model=None``
  calibrates from tiny real sample builds).

On one card the "instances" are threads that share it.  Each worker owns a
``torch.cuda.Stream``, and its attempts run inside it: a worker's K3
launches, prune and reverse-edge ops queue on its own stream, and the
device reads its build makes (the round's distance counter, the final
graph) wait for that stream alone, not for the other worker's work.  The
dispatcher thread never touches the card.  Shards are not padded to a
shared size (the reference pads so that one jit trace serves every shard;
nothing here traces), and the graphs are the same.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np
import torch

from repro_torch.configs.base import IndexConfig
from repro_torch.core import cost_model
from repro_torch.core.builder import BuildResult, ShardBuildError
from repro_torch.core.merge import merge_shard_indexes
from repro_torch.core.partition import partition
from repro_torch.core.scheduler import (CPU_MACHINE, V100_SPOT,
                                        CostGreedyPolicy, InstanceType,
                                        RuntimeModel, Task, calibrate_runtime)
from repro_torch.core.vamana import (DEFAULT_BUILD_BATCH,
                                     build_shard_index_vamana)
from repro_torch.device import resolve_device
from repro_torch.fleet.checkpoint import CheckpointStore, ShardCheckpoint
from repro_torch.fleet.injector import Preempted, PreemptionInjector
from repro_torch.telemetry import MetricsRegistry, current_tracer


@dataclasses.dataclass
class ShardTimeline:
    """One shard's life through the fleet, in fleet-relative seconds —
    every attempt start, checkpoint save, kill/notice, resume and finish
    that touched it, plus the aggregate round/checkpoint counts.  This is
    the per-shard cut of ``FleetReport.events`` (same tuples), so a
    postmortem of one stuck shard doesn't grep the whole fleet log."""

    shard: int
    attempts: int
    rounds_completed: int
    checkpoints_saved: int
    events: list[tuple]  # (t_s, kind, worker, shard, detail), time order


@dataclasses.dataclass
class FleetReport:
    """Telemetry of one fleet build (feeds ``BENCH_fleet.json``)."""

    policy: str
    n_workers: int
    n_shards: int
    n_preemptions: int
    n_resumes: int
    n_requeues: int
    n_error_retries: int
    n_notices: int
    rounds_completed: int
    rounds_lost: int  # rounds re-run because they post-dated the last ckpt
    shard_attempts: list[int]
    partition_s: float
    fleet_wall_s: float
    merge_s: float
    accelerator_active_s: float
    makespan_s: float
    cost: cost_model.CostBreakdown
    runtime_model: RuntimeModel
    events: list[tuple]  # (t_s, kind, worker, shard, detail)
    shard_timelines: list[ShardTimeline] = dataclasses.field(
        default_factory=list
    )
    metrics: dict = dataclasses.field(default_factory=dict)
    # ^ the run's MetricsRegistry snapshot (fleet_* counters)


@dataclasses.dataclass
class FleetBuildResult:
    build: BuildResult
    report: FleetReport


@dataclasses.dataclass
class _Worker:
    wid: int
    itype: InstanceType
    known_remaining_rounds: float | None = None  # set once a notice fires
    active_s: float = 0.0
    stream: torch.cuda.Stream | None = None  # the worker's own (None: CPU)

    # duck-type the SchedulingPolicy.instance_key surface


def _task_remaining_rounds(task: Task, ckpt: ShardCheckpoint | None,
                           nb: int) -> int:
    total = 2 * max(1, math.ceil(task.size / nb))
    if ckpt is None:
        return total
    return max(1, total - ckpt.round_idx)


def build_scalegann_fleet(
    data: np.ndarray,
    cfg: IndexConfig,
    *,
    n_workers: int = 2,
    selective: bool = True,
    algo: str = "vamana",
    backend: str = "fused",
    batch_size: int | None = None,
    seed: int = 0,
    injector: PreemptionInjector | None = None,
    policy=None,
    runtime_model: RuntimeModel | None = None,
    checkpoint_store: CheckpointStore | None = None,
    checkpoint_every_rounds: int = 1,
    max_error_retries: int = 2,
    max_requeues: int = 64,
    backoff_base_s: float = 0.01,
    backoff_cap_s: float = 1.0,
    deadline_slack: float = 3.0,
    accel_itype: InstanceType = V100_SPOT,
    cpu_itype: InstanceType = CPU_MACHINE,
    tracer=None,
    registry: MetricsRegistry | None = None,
    device=None,
) -> FleetBuildResult:
    """Partition → preemption-tolerant fleet shard builds → merge.

    Only ``algo="vamana"`` is supported — the batched Vamana rounds are
    the checkpoint grain; CAGRA's NN-descent has no equivalent cut point
    yet.  With ``injector=None`` this degrades to a plain (but retrying,
    policy-ordered) distributed build.  See the module docstring for the
    full lifecycle.

    ``tracer`` (default: the process-wide :func:`current_tracer`) renders
    the whole run on one timeline: each worker gets a track carrying its
    ``fleet.shard_build`` attempt spans with kill/notice instants and
    checkpoint/resume spans nested inside; backoff windows land on
    per-shard tracks (a killed worker starts its next attempt immediately,
    so the wait belongs to the *shard*, not the worker).  Per-round
    ``vamana.round`` spans follow the process-global tracer — install
    yours with :func:`repro_torch.telemetry.use_tracer` to get them too.
    ``registry`` collects the run's ``fleet_*`` counters (rounds,
    checkpoints, preemptions, ...); it defaults to a *fresh* registry per
    run so ``FleetReport.metrics`` is per-run, not process-cumulative.

    The partition, the calibration builds and the shard builds run on
    ``device`` (the card unless ``"cpu"`` is given; without CUDA the call
    raises), the builds on ``backend`` (``"fused"``: K3 on the card), each
    worker's on its own stream.
    """
    if algo != "vamana":
        raise ValueError(
            "fleet builds checkpoint at Vamana round grain; "
            f"algo={algo!r} is not supported (use build_scalegann)"
        )
    dev = resolve_device(device)
    policy = policy or CostGreedyPolicy()
    store = checkpoint_store or CheckpointStore()
    nb = batch_size or DEFAULT_BUILD_BATCH
    tr = current_tracer() if tracer is None else tracer
    reg = MetricsRegistry() if registry is None else registry
    c_rounds = reg.counter("fleet_rounds_total", "completed build rounds")
    c_dist = reg.counter("fleet_distance_computations_total",
                         "distance computations across shard builds")
    c_ckpt = reg.counter("fleet_checkpoint_saves_total",
                         "round-grain checkpoints persisted")
    c_preempt = reg.counter("fleet_preemptions_total", "kill signals eaten")
    c_resume = reg.counter("fleet_resumes_total", "checkpoint resumes")
    c_notice = reg.counter("fleet_notices_total",
                           "preemption notices observed")
    c_requeue = reg.counter("fleet_requeues_total",
                            "task requeues after preemption")
    c_retry = reg.counter("fleet_error_retries_total",
                          "task requeues after a build error")

    t_all = time.perf_counter()
    with tr.span("fleet.partition", track="fleet"):
        part = partition(data, cfg, selective=selective, device=dev)
    partition_s = time.perf_counter() - t_all

    if runtime_model is None:
        # paper §IV: fit the linear size→time model on tiny *real* builds
        cal_sizes = tuple(
            s for s in (256, 512, 1024) if s <= max(256, len(data))
        )
        with tr.span("fleet.calibrate", track="fleet"):
            runtime_model = calibrate_runtime(
                None, data, cal_sizes, cfg=cfg, backend=backend, seed=seed,
                device=dev,
            )

    shards = part.shards
    sizes = [len(s.ids) for s in shards]

    tasks = [
        Task(tid=i, shard=i, size=sizes[i],
             deadline_s=deadline_slack
             * runtime_model.estimate(sizes[i], accel_itype))
        for i in range(len(shards))
    ]
    workers = [
        _Worker(wid=w, itype=accel_itype,
                stream=(torch.cuda.Stream(dev) if dev.type == "cuda"
                        else None))
        for w in range(n_workers)
    ]
    if injector is not None:
        for w in workers:
            injector.start_instance(w.wid)

    lock = threading.Lock()  # guards worker notice marks from hook threads
    results: list = [None] * len(shards)
    per_shard_s = [0.0] * len(shards)
    attempts = [0] * len(shards)
    errors: list[str | None] = [None] * len(shards)
    requeues = {t.tid: 0 for t in tasks}
    err_retries = {t.tid: 0 for t in tasks}
    counters = {
        "preempt": 0, "resume": 0, "rounds": 0, "rounds_lost": 0,
    }
    rounds_by_shard = [0] * len(shards)
    ckpts_by_shard = [0] * len(shards)
    events: list[tuple] = []
    t_fleet = time.perf_counter()

    def stamp() -> float:
        return time.perf_counter() - t_fleet

    def run_task(task: Task, worker: _Worker):
        """One attempt of one shard on one worker — runs in the pool.

        The attempt is one ``fleet.shard_build`` span on the worker's
        track; resume/checkpoint spans and kill/notice instants nest
        inside it (the per-round ``vamana.round`` spans inherit the track
        from this thread's open span).  The build runs on the worker's
        stream.
        """
        wtrack = f"worker-{worker.wid}"
        attempt_idx = task.attempts - 1  # set by the dispatcher pre-submit
        with tr.span("fleet.shard_build", track=wtrack,
                     shard=task.shard, attempt=task.attempts):
            t_load0 = tr.now()
            ckpt = store.load(task.shard)  # crosses the serialize roundtrip
            if ckpt is not None:
                if ckpt.seed != seed or ckpt.batch_size != nb:
                    raise ValueError(
                        f"shard {task.shard} checkpoint was written with "
                        f"seed={ckpt.seed} batch_size={ckpt.batch_size}; "
                        f"resume requires the same (got {seed}/{nb})"
                    )
                with lock:
                    counters["resume"] += 1
                c_resume.inc()
                events.append((stamp(), "resume", worker.wid, task.shard,
                               f"round {ckpt.round_idx}"))
                if tr.enabled:
                    tr.complete("fleet.resume", t_load0, tr.now(),
                                track=wtrack, shard=task.shard,
                                round=ckpt.round_idx)
            last_saved = [ckpt.round_idx if ckpt else 0]
            prev_dc = [int(ckpt.n_distance_computations) if ckpt else 0]

            def hook(state):
                with lock:
                    counters["rounds"] += 1
                    rounds_by_shard[task.shard] += 1
                c_rounds.inc()
                c_dist.inc(
                    max(state.n_distance_computations - prev_dc[0], 0)
                )
                prev_dc[0] = state.n_distance_computations
                sig = None
                if injector is not None:
                    sig = injector.observe_round(
                        worker.wid, task.shard, attempt_idx, state.round_idx
                    )
                if sig == "kill":
                    # the instance is gone mid-window — no time to persist
                    # this round; resume replays from the last saved
                    # checkpoint (rounds_lost accounts the replay)
                    events.append((stamp(), "kill", worker.wid, task.shard,
                                   f"round {state.round_idx}"))
                    if tr.enabled:
                        tr.instant("fleet.preempt.kill", track=wtrack,
                                   shard=task.shard, round=state.round_idx)
                    raise Preempted(
                        store.load(task.shard), worker=worker.wid,
                        shard=task.shard,
                        lost_rounds=state.round_idx - last_saved[0],
                    )
                due = (state.round_idx - last_saved[0]
                       >= checkpoint_every_rounds)
                if due or sig == "notice":  # §II-B: the notice window is
                    t_ck0 = tr.now()        # for exactly this — ckpt now
                    ck = ShardCheckpoint(
                        shard=task.shard, pass_idx=state.pass_idx,
                        next_start=state.next_start, graph=state.graph,
                        n_distance_computations=(
                            state.n_distance_computations
                        ),
                        n=state.n, R=state.R, seed=seed, batch_size=nb,
                        round_idx=state.round_idx,
                        n_rounds_total=state.n_rounds_total,
                    )
                    store.save(ck)
                    last_saved[0] = state.round_idx
                    c_ckpt.inc()
                    with lock:
                        ckpts_by_shard[task.shard] += 1
                    events.append((stamp(), "checkpoint", worker.wid,
                                   task.shard,
                                   f"round {state.round_idx}"))
                    if tr.enabled:
                        tr.complete("fleet.checkpoint", t_ck0, tr.now(),
                                    track=wtrack, shard=task.shard,
                                    round=state.round_idx)
                if sig == "notice":
                    c_notice.inc()
                    events.append((stamp(), "notice", worker.wid,
                                   task.shard,
                                   f"round {state.round_idx}"))
                    if tr.enabled:
                        tr.instant("fleet.preempt.notice", track=wtrack,
                                   shard=task.shard,
                                   round=state.round_idx)
                    with lock:
                        worker.known_remaining_rounds = \
                            injector.known_remaining_rounds(worker.wid)

            vecs = np.asarray(data[shards[task.shard].ids])
            with torch.cuda.stream(worker.stream):  # None: a no-op
                return build_shard_index_vamana(
                    vecs, cfg, seed=seed, backend=backend,
                    batch_size=batch_size, round_hook=hook, resume=ckpt,
                    device=dev,
                )

    # --- dispatch loop: availability + time-based admission, policy order
    pending: list[tuple] = []
    not_before = {t.tid: 0.0 for t in tasks}
    for t in tasks:
        heapq.heappush(
            pending, (*policy.task_key(t, runtime_model), t.tid)
        )
    free = list(range(n_workers))
    running: dict = {}  # future -> (task, worker, t_started)
    n_done = 0

    dispatch_span = tr.span("fleet.dispatch", track="fleet",
                            n_workers=n_workers, n_shards=len(shards))
    with dispatch_span, ThreadPoolExecutor(max_workers=n_workers) as pool:
        while n_done < len(shards):
            now = stamp()
            # dispatch as many pending tasks as admission allows
            held: list[tuple] = []
            while pending and free:
                key = heapq.heappop(pending)
                task = tasks[key[-1]]
                if not_before[task.tid] > now:
                    held.append(key)
                    continue
                ckpt = store.load(task.shard)
                need = _task_remaining_rounds(task, ckpt, nb)
                free.sort(
                    key=lambda w: policy.instance_key(workers[w])
                )
                chosen = None
                for w in free:
                    rem = workers[w].known_remaining_rounds
                    if rem is None or need <= rem:  # time-based policy
                        chosen = w
                        break
                if chosen is None and not running:
                    # every free worker is on notice and too short-lived,
                    # nothing else is running: progress beats starvation —
                    # checkpoints make even a doomed attempt useful
                    chosen = free[0]
                if chosen is None:
                    held.append(key)
                    continue
                free.remove(chosen)
                task.attempts += 1
                attempts[task.shard] = task.attempts
                fut = pool.submit(run_task, task, workers[chosen])
                running[fut] = (task, chosen, stamp())
                events.append((now, "start", chosen, task.shard,
                               f"attempt {task.attempts}"))
            for key in held:
                heapq.heappush(pending, key)

            if not running:
                # everything pending is backing off — sleep to the nearest
                wake = min(
                    (not_before[k[-1]] for k in pending), default=now
                )
                time.sleep(max(wake - now, backoff_base_s / 4))
                continue

            done_set, _ = wait(running, return_when=FIRST_COMPLETED)
            for fut in done_set:
                task, w, t0 = running.pop(fut)
                dur = stamp() - t0
                workers[w].active_s += dur
                per_shard_s[task.shard] += dur
                try:
                    idx = fut.result()
                except Preempted as p:
                    counters["preempt"] += 1
                    counters["rounds_lost"] += max(0, p.lost_rounds)
                    c_preempt.inc()
                    c_requeue.inc()
                    requeues[task.tid] += 1
                    if requeues[task.tid] > max_requeues:
                        raise RuntimeError(
                            f"shard {task.shard} exceeded max_requeues="
                            f"{max_requeues} under preemption"
                        )
                    delay = min(
                        backoff_base_s * (2 ** (requeues[task.tid] - 1)),
                        backoff_cap_s,
                    )
                    not_before[task.tid] = stamp() + delay
                    heapq.heappush(
                        pending,
                        (*policy.task_key(task, runtime_model), task.tid),
                    )
                    events.append((stamp(), "preempted", w, task.shard,
                                   f"requeue in {delay * 1e3:.0f}ms"))
                    if tr.enabled:
                        # the wait belongs to the *shard*: the worker that
                        # ate the kill picks up new work immediately, so a
                        # worker-track span here would overlap its next
                        # attempt
                        tn = tr.now()
                        tr.complete("fleet.backoff", tn, tn + delay,
                                    track=f"shard-{task.shard}",
                                    shard=task.shard, reason="preempted",
                                    requeue=requeues[task.tid])
                    # replacement instance for the lost one
                    if injector is not None:
                        injector.start_instance(w)
                    with lock:
                        workers[w].known_remaining_rounds = None
                    free.append(w)
                except Exception as e:  # noqa: BLE001 — bounded retry
                    errors[task.shard] = f"{type(e).__name__}: {e}"
                    c_retry.inc()
                    err_retries[task.tid] += 1
                    if err_retries[task.tid] > max_error_retries:
                        raise ShardBuildError(
                            {task.shard: e},
                            {task.shard: task.attempts},
                        ) from e
                    delay = min(
                        backoff_base_s
                        * (2 ** (err_retries[task.tid] - 1)),
                        backoff_cap_s,
                    )
                    not_before[task.tid] = stamp() + delay
                    heapq.heappush(
                        pending,
                        (*policy.task_key(task, runtime_model), task.tid),
                    )
                    events.append((stamp(), "error", w, task.shard,
                                   errors[task.shard]))
                    if tr.enabled:
                        tn = tr.now()
                        tr.complete("fleet.backoff", tn, tn + delay,
                                    track=f"shard-{task.shard}",
                                    shard=task.shard, reason="error",
                                    requeue=err_retries[task.tid])
                    free.append(w)
                else:
                    results[task.shard] = idx
                    store.discard(task.shard)
                    n_done += 1
                    events.append((stamp(), "done", w, task.shard,
                                   f"{dur:.3f}s"))
                    free.append(w)

    fleet_wall_s = time.perf_counter() - t_fleet

    t0 = time.perf_counter()
    with tr.span("fleet.merge", track="fleet"):
        merged = merge_shard_indexes(
            shards, results, len(data), cfg.degree, data=data
        )
    merge_s = time.perf_counter() - t0
    makespan_s = time.perf_counter() - t_all

    build = BuildResult(
        name=f"scalegann-fleet[{algo}]",
        index=merged,
        shards=shards,
        shard_graphs=[i.graph for i in results],
        partition_s=partition_s,
        build_only_s=sum(per_shard_s),
        wall_build_s=fleet_wall_s,
        merge_s=merge_s,
        per_shard_s=per_shard_s,
        n_distance_computations=sum(
            i.n_distance_computations for i in results
        ),
        stats=dict(part.stats),
        centroids=part.centroids,
        shard_attempts=attempts,
        shard_errors=errors,
    )
    shard_bytes = float(max(sizes) * data.shape[1] * 4) if sizes else 0.0
    report = FleetReport(
        policy=getattr(policy, "name", type(policy).__name__),
        n_workers=n_workers,
        n_shards=len(shards),
        n_preemptions=counters["preempt"],
        n_resumes=counters["resume"],
        n_requeues=sum(requeues.values()),
        n_error_retries=sum(err_retries.values()),
        n_notices=injector.n_notices if injector else 0,
        rounds_completed=counters["rounds"],
        rounds_lost=counters["rounds_lost"],
        shard_attempts=attempts,
        partition_s=partition_s,
        fleet_wall_s=fleet_wall_s,
        merge_s=merge_s,
        accelerator_active_s=sum(w.active_s for w in workers),
        makespan_s=makespan_s,
        cost=cost_model.fleet_cost(
            makespan_s, sum(w.active_s for w in workers), len(shards),
            shard_bytes, cpu=cpu_itype, accel=accel_itype,
        ),
        runtime_model=runtime_model,
        events=events,
        shard_timelines=[
            ShardTimeline(
                shard=s, attempts=attempts[s],
                rounds_completed=rounds_by_shard[s],
                checkpoints_saved=ckpts_by_shard[s],
                events=sorted((e for e in events if e[3] == s),
                              key=lambda e: e[0]),
            )
            for s in range(len(shards))
        ],
        metrics=reg.snapshot(),
    )
    return FleetBuildResult(build=build, report=report)
