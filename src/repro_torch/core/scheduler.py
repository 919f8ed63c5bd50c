"""Cloud-instance task scheduler + spot-lifecycle simulator (paper §IV;
counterpart of ``repro/core/scheduler.py``, a copy: the simulator is
framework-free, so the same tasks and pool give equal ``SimResult``s, and
only :func:`calibrate_runtime`'s default build is the port's).

The paper's scheduler maintains a *task list* (pending shard-index builds)
and a *cloud instance list* (active accelerator instances with Active /
Available / Time-remaining status) and applies two policies:

  (1) **Availability-based** — never assign to an instance already running a
      task.
  (2) **Time-based** — estimate each task's runtime (linear in shard size,
      calibrated from tiny sample builds) and never assign a task to an
      instance whose remaining lifetime cannot finish it; when a preemption
      notice arrives, prefer tasks that fit in the notice window.

On termination with an unfinished task, the task is re-allocated (§IV).

Beyond-paper extensions (paper §VIII future work — implemented here):
  * **checkpoint-based resume** — a preempted task restarts from its last
    checkpoint fraction instead of from zero;
  * **straggler mitigation** — speculative duplicate of a task running past
    ``straggler_factor``×estimate; first copy to finish wins;
  * **heterogeneous pools** — instance types differ in speed and price; the
    runtime estimate scales by instance speed and assignment prefers the
    cheapest $\\cdot$ fastest feasible instance.

Everything is event-driven over a virtual clock, so tests can simulate
thousands of instances in milliseconds (1000+-node posture), and the same
``Scheduler``'s policies order the *real* fleet executor in
``repro_torch.fleet`` (virtual time swapped for wall time).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Instance / task records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InstanceType:
    """An accelerator machine SKU (paper §VI-C: p3.8xlarge-like)."""

    name: str
    price_per_hour: float
    n_accelerators: int = 4
    hbm_gb: float = 16.0
    speed: float = 1.0  # relative shard-build throughput vs the calibration machine
    spot: bool = True
    safe_duration_s: float = 3600.0  # §II-B: protected first hour
    notice_s: float = 300.0  # §II-B: 5-minute preemption notice


V100_SPOT = InstanceType("v100x4_spot", price_per_hour=3.67)
V100_ONDEMAND = InstanceType(
    "v100x4_ondemand", price_per_hour=13.7, spot=False,
    safe_duration_s=math.inf, notice_s=0.0,
)
CPU_MACHINE = InstanceType(
    "c5d24xlarge", price_per_hour=4.6, n_accelerators=0, spot=False,
    safe_duration_s=math.inf, notice_s=0.0, speed=0.0,
)


@dataclasses.dataclass
class Instance:
    iid: int
    itype: InstanceType
    launched_at: float
    # hidden ground truth (the provider knows; the scheduler does not until
    # the notice fires):
    lifetime_s: float = math.inf
    # scheduler-visible state:
    active: bool = True
    running_task: Optional[int] = None
    notice_deadline: Optional[float] = None  # set when preemption notice fires
    busy_until: float = 0.0
    active_time: float = 0.0  # billed accelerator-seconds

    def available(self) -> bool:
        return self.active and self.running_task is None

    def time_remaining(self, now: float) -> float:
        """Scheduler-visible remaining lifetime (paper: 'if we have accurate
        information about its remaining active lifetime')."""
        if self.notice_deadline is not None:
            return max(self.notice_deadline - now, 0.0)
        safe_end = self.launched_at + self.itype.safe_duration_s
        if now < safe_end:
            return safe_end - now
        return math.inf  # unknown — no notice yet


@dataclasses.dataclass
class Task:
    tid: int
    shard: int
    size: int  # vectors in the shard
    state: str = "pending"  # pending | running | done | preempted
    progress: float = 0.0  # checkpointed fraction (resume extension)
    attempts: int = 0
    assigned_to: Optional[int] = None
    started_at: float = 0.0
    finished_at: float = 0.0
    speculative_of: Optional[int] = None  # straggler duplicate of task tid
    deadline_s: float = math.inf  # EDD policy input (inf = no deadline)


# ---------------------------------------------------------------------------
# Runtime estimation (paper: "construction time scales linearly with dataset
# size"; calibrated on tiny sample builds)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RuntimeModel:
    seconds_per_vector: float
    fixed_overhead_s: float = 0.0

    def estimate(self, size: int, itype: InstanceType) -> float:
        speed = itype.speed if itype.speed > 0 else 1.0
        return self.fixed_overhead_s + self.seconds_per_vector * size / speed


def calibrate_runtime(
    build_fn: Callable[[np.ndarray], object] | None,
    data: np.ndarray,
    sample_sizes: tuple[int, ...] = (512, 1024, 2048),
    *,
    timer: Callable[[], float] | None = None,
    seed: int = 0,
    cfg=None,
    backend: str = "numpy",
    device=None,
) -> RuntimeModel:
    """Paper §IV: 'sample multiple tiny subsets from the dataset and measure
    their index construction time', then fit time ≈ a·size + b.

    ``build_fn=None`` calibrates against the *real* vectorized shard
    builder (``repro_torch.core.vamana.build_shard_index_vamana`` with
    ``cfg``, or paper-shaped small defaults, on ``backend`` and ``device``:
    the card unless ``"cpu"`` is given) — the model the fleet executor and
    :func:`Scheduler` estimates use by default, instead of hand-set
    constants.  A warm-up build at the smallest sample size runs first so
    one-off costs (the kernels' ``nvcc`` build and first launch on the
    card) don't leak into the linear fit (they would show up as a wildly
    inflated intercept *and* slope).  A build returns host arrays, so each
    timed build has finished on the card when the timer reads."""
    import time as _time

    if build_fn is None:
        from repro_torch.configs.base import IndexConfig
        from repro_torch.core.vamana import build_shard_index_vamana
        from repro_torch.device import resolve_device

        dev = resolve_device(device)
        build_cfg = cfg or IndexConfig(
            n_clusters=1, degree=16, build_degree=32, block_size=1024
        )
        build_fn = lambda x: build_shard_index_vamana(  # noqa: E731
            x, build_cfg, backend=backend, device=dev
        )
        warm = min(min(sample_sizes), len(data))
        build_fn(np.asarray(data[:warm]))  # warm-up: pay traces off-fit

    timer = timer or _time.perf_counter
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for s in sample_sizes:
        s = min(s, len(data))
        idx = rng.choice(len(data), size=s, replace=False)
        t0 = timer()
        build_fn(np.asarray(data[idx]))
        ys.append(timer() - t0)
        xs.append(s)
    a, b = np.polyfit(np.asarray(xs, float), np.asarray(ys, float), 1)
    return RuntimeModel(seconds_per_vector=max(float(a), 1e-12),
                        fixed_overhead_s=max(float(b), 0.0))


# ---------------------------------------------------------------------------
# Pluggable scheduling policies (paper §IV policies stay the admission
# layer; the *ordering* of pending tasks and the instance preference are
# policy decisions — shared by the virtual-clock Scheduler below and the
# real-build fleet executor in ``repro_torch.fleet``)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostGreedyPolicy:
    """The paper's default posture: largest task first (longest-processing-
    time packing), cheapest-feasible instance, spot preferred over
    on-demand ('always prefers activating the spot GPU instances')."""

    name: str = "cost_greedy"

    def task_key(self, task: Task, model: RuntimeModel) -> tuple:
        return (-task.size,)

    def instance_key(self, inst: Instance) -> tuple:
        speed = max(inst.itype.speed, 1e-9)
        return (
            not inst.itype.spot,
            inst.itype.price_per_hour / speed,
            -inst.itype.speed,
        )


@dataclasses.dataclass(frozen=True)
class DeadlinePolicy:
    """Earliest-due-date (EDD): tasks carry ``deadline_s`` and the most
    urgent pending task dispatches first, onto the *fastest* feasible
    instance (price is secondary when a deadline is at risk).  Tasks
    without deadlines fall back to largest-first among themselves."""

    name: str = "edd"

    def task_key(self, task: Task, model: RuntimeModel) -> tuple:
        return (task.deadline_s, -task.size)

    def instance_key(self, inst: Instance) -> tuple:
        speed = max(inst.itype.speed, 1e-9)
        return (
            -inst.itype.speed,
            inst.itype.price_per_hour / speed,
            not inst.itype.spot,
        )


SCHEDULING_POLICIES = {
    "cost_greedy": CostGreedyPolicy,
    "edd": DeadlinePolicy,
}


# ---------------------------------------------------------------------------
# Event-driven simulator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimResult:
    makespan_s: float
    gpu_active_s: float  # Σ per-instance busy time (billed, paper cost model)
    instance_wall_s: float  # Σ active (launched→terminated/idle-released)
    n_preemptions: int
    n_restarts: int
    n_speculative: int
    work_lost_s: float
    task_log: list
    per_instance_busy: dict


class Scheduler:
    """Paper §IV scheduler over a virtual clock.

    ``lifetimes`` (per instance, seconds) is the hidden ground truth the
    *simulator* applies; the scheduler only learns a termination
    ``notice_s`` in advance (and knows the safe duration).
    """

    def __init__(
        self,
        tasks: list[Task],
        instances: list[Instance],
        runtime_model: RuntimeModel,
        *,
        checkpoint_resume: bool = False,
        checkpoint_interval_s: float = 60.0,
        straggler_factor: float = 0.0,  # 0 disables speculation
        slowdown: Callable[[int, int], float] | None = None,
        # slowdown(iid, tid) -> multiplicative runtime factor (stragglers)
        policy: "CostGreedyPolicy | DeadlinePolicy | None" = None,
    ):
        self.tasks = {t.tid: t for t in tasks}
        self.instances = {i.iid: i for i in instances}
        self.model = runtime_model
        self.policy = policy or CostGreedyPolicy()
        self.checkpoint_resume = checkpoint_resume
        self.checkpoint_interval_s = checkpoint_interval_s
        self.straggler_factor = straggler_factor
        self.slowdown = slowdown or (lambda iid, tid: 1.0)
        self.now = 0.0
        self._events: list[tuple[float, int, str, int]] = []
        self._eid = 0
        self._next_tid = max(self.tasks) + 1 if self.tasks else 0
        self._pending: list[tuple] = []
        for t in self.tasks.values():
            if t.state == "pending":
                self._push_pending(t)
        self._all_shards = {t.shard for t in self.tasks.values()}
        self._done_shards: set[int] = set()
        self._idle: set[int] = {
            i.iid for i in self.instances.values() if i.available()
        }
        self.n_preemptions = 0
        self.n_restarts = 0
        self.n_speculative = 0
        self.work_lost_s = 0.0
        self.task_log: list = []

    # --- event queue ---
    def _push(self, when: float, kind: str, ref: int,
              attempt: int = -1) -> None:
        heapq.heappush(self._events, (when, self._eid, kind, ref, attempt))
        self._eid += 1

    # --- policies ---
    def _feasible(self, task: Task, inst: Instance) -> bool:
        if not inst.available():  # (1) availability-based
            return False
        est = self.model.estimate(task.size, inst.itype)
        if self.checkpoint_resume:
            est *= 1.0 - task.progress
        return est <= inst.time_remaining(self.now)  # (2) time-based

    def _pick_instance(self, task: Task) -> Optional[Instance]:
        """Best feasible among *idle* instances, ranked by the active
        :class:`SchedulingPolicy` (default :class:`CostGreedyPolicy`:
        cheapest-feasible, ties to fastest, spot preferred — the paper's
        'always prefers activating the spot GPU instances')."""
        cands = [
            self.instances[i] for i in self._idle
            if self._feasible(task, self.instances[i])
        ]
        if not cands:
            return None
        return min(cands, key=self.policy.instance_key)

    def _push_pending(self, task: Task) -> None:
        heapq.heappush(
            self._pending,
            (task.speculative_of is None,
             *self.policy.task_key(task, self.model), task.tid),
        )

    # --- lifecycle ---
    def _start(self, task: Task, inst: Instance) -> None:
        remaining = 1.0 - (task.progress if self.checkpoint_resume else 0.0)
        dur = (
            self.model.estimate(task.size, inst.itype)
            * remaining
            * self.slowdown(inst.iid, task.tid)
        )
        task.state = "running"
        task.assigned_to = inst.iid
        task.started_at = self.now
        task.attempts += 1
        inst.running_task = task.tid
        inst.busy_until = self.now + dur
        self._idle.discard(inst.iid)
        self._push(self.now + dur, "finish", task.tid, task.attempts)
        if self.straggler_factor > 0:
            watchdog = self.now + self.straggler_factor * self.model.estimate(
                task.size, inst.itype
            )
            self._push(watchdog, "watchdog", task.tid)

    def _finish(self, task: Task, *, lost: bool) -> None:
        inst = self.instances[task.assigned_to]
        ran = self.now - task.started_at
        inst.active_time += ran
        inst.running_task = None
        if inst.active:
            self._idle.add(inst.iid)
        if lost:
            if self.checkpoint_resume:
                est = self.model.estimate(task.size, inst.itype)
                ckpts = math.floor(ran / self.checkpoint_interval_s)
                saved = min(ckpts * self.checkpoint_interval_s / max(est, 1e-9),
                            0.99)
                self.work_lost_s += ran - saved * est
                task.progress = max(task.progress, saved)
            else:
                self.work_lost_s += ran
                task.progress = 0.0
            task.state = "pending"
            task.assigned_to = None
            self.n_restarts += 1
            self._push_pending(task)
        else:
            task.state = "done"
            task.finished_at = self.now
            self._done_shards.add(task.shard)
            # cancel speculative siblings
            for t in self.tasks.values():
                same = t.speculative_of == task.tid or (
                    task.speculative_of is not None
                    and (t.tid == task.speculative_of
                         or t.speculative_of == task.speculative_of)
                )
                if same and t.tid != task.tid and t.state in ("pending",
                                                              "running"):
                    if t.state == "running":
                        i2 = self.instances[t.assigned_to]
                        i2.active_time += self.now - t.started_at
                        i2.running_task = None
                        if i2.active:
                            self._idle.add(i2.iid)
                    t.state = "done"
        self.task_log.append(
            (self.now, task.tid, "lost" if lost else "done", inst.iid)
        )

    # --- main loop ---
    def run(self) -> SimResult:
        # seed preemption notices/terminations from hidden lifetimes
        for inst in self.instances.values():
            if math.isfinite(inst.lifetime_s):
                t_end = inst.launched_at + inst.lifetime_s
                self._push(max(t_end - inst.itype.notice_s, 0.0), "notice",
                           inst.iid)
                self._push(t_end, "terminate", inst.iid)
        # deliver time-0 notices before the first dispatch (the scheduler
        # must not assign long tasks to instances already on notice)
        while self._events and self._events[0][0] <= 0.0 \
                and self._events[0][2] == "notice":
            _, _, _, ref, _ = heapq.heappop(self._events)
            inst = self.instances[ref]
            if inst.active:
                inst.notice_deadline = inst.launched_at + inst.lifetime_s
        self._dispatch()
        while self._events:
            if len(self._done_shards) == len(self._all_shards):
                break
            when, _, kind, ref, attempt = heapq.heappop(self._events)
            self.now = max(self.now, when)
            if kind == "finish":
                task = self.tasks[ref]
                if (
                    task.state == "running"
                    and task.attempts == attempt  # not a stale pre-retry event
                    and self.instances[task.assigned_to].active
                    and self.instances[task.assigned_to].running_task == ref
                ):
                    self._finish(task, lost=False)
            elif kind == "notice":
                inst = self.instances[ref]
                if inst.active:
                    inst.notice_deadline = (
                        inst.launched_at + inst.lifetime_s
                    )
            elif kind == "terminate":
                inst = self.instances[ref]
                if not inst.active:
                    continue
                inst.active = False
                self._idle.discard(inst.iid)
                self.n_preemptions += 1
                if inst.running_task is not None:
                    task = self.tasks[inst.running_task]
                    self._finish(task, lost=True)
            elif kind == "watchdog":
                task = self.tasks[ref]
                if (
                    task.state == "running"
                    and task.speculative_of is None
                    and not any(
                        t.speculative_of == ref for t in self.tasks.values()
                    )
                ):
                    dup = Task(
                        tid=self._next_tid, shard=task.shard, size=task.size,
                        progress=task.progress, speculative_of=ref,
                    )
                    self._next_tid += 1
                    self.tasks[dup.tid] = dup
                    self.n_speculative += 1
                    self._push_pending(dup)
            self._dispatch()
        done = [t for t in self.tasks.values() if t.state == "done"]
        unsat = self._all_shards - self._done_shards
        if unsat:
            raise RuntimeError(
                f"{len(unsat)} shard tasks unschedulable (no instance with "
                "enough remaining lifetime) — add instances or enable "
                "checkpoint_resume"
            )
        makespan = max((t.finished_at for t in done), default=0.0)
        per_busy = {i.iid: i.active_time for i in self.instances.values()}
        wall = sum(
            (min(i.launched_at + i.lifetime_s, makespan)
             if math.isfinite(i.lifetime_s) else makespan) - i.launched_at
            for i in self.instances.values()
        )
        return SimResult(
            makespan_s=makespan,
            gpu_active_s=sum(per_busy.values()),
            instance_wall_s=wall,
            n_preemptions=self.n_preemptions,
            n_restarts=self.n_restarts,
            n_speculative=self.n_speculative,
            work_lost_s=self.work_lost_s,
            task_log=self.task_log,
            per_instance_busy=per_busy,
        )

    def _dispatch(self) -> None:
        """Task-driven assignment: highest-priority pending task first, onto
        the best feasible idle instance (spot-preferred, cheapest·fastest).
        Tasks with no feasible instance *now* stay pending (time-based
        policy); loop exits as soon as no instance is idle."""
        for iid in list(self._idle):
            if not self.instances[iid].available():
                self._idle.discard(iid)
        side = []
        while self._pending and self._idle:
            key = heapq.heappop(self._pending)
            task = self.tasks[key[-1]]
            if task.state != "pending":
                continue  # stale
            inst = self._pick_instance(task)
            if inst is None:
                side.append(key)
            else:
                self._start(task, inst)
        for key in side:
            heapq.heappush(self._pending, key)


# ---------------------------------------------------------------------------
# Convenience builders
# ---------------------------------------------------------------------------


def make_tasks(shard_sizes: list[int]) -> list[Task]:
    return [Task(tid=i, shard=i, size=int(s)) for i, s in
            enumerate(shard_sizes)]


def make_spot_pool(
    n: int,
    itype: InstanceType = V100_SPOT,
    *,
    mean_lifetime_s: float = 7200.0,
    seed: int = 0,
) -> list[Instance]:
    """Spot instances with exponential lifetimes after the safe duration
    (empirical spot-market behaviour; §II-B)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        extra = rng.exponential(mean_lifetime_s)
        out.append(
            Instance(
                iid=i, itype=itype, launched_at=0.0,
                lifetime_s=itype.safe_duration_s + extra,
            )
        )
    return out


def make_ondemand_pool(n: int, itype: InstanceType = V100_ONDEMAND
                       ) -> list[Instance]:
    return [Instance(iid=i, itype=itype, launched_at=0.0) for i in range(n)]
