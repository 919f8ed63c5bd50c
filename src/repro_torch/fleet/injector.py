"""Deterministic spot-preemption injection at build-round grain
(counterpart of ``repro/fleet/injector.py``, a copy: the same seed gives
the same lifetimes and the same signals).

A real spot fleet loses instances on the provider's clock; a test fleet
needs the *same* kills on every run regardless of thread scheduling.  The
injector therefore counts **completed build rounds per worker** — the only
clock the build itself advances — and delivers the paper's §II-B lifecycle
on it: a ``"notice"`` signal ``notice_rounds`` before the end of the
instance's (seeded) lifetime, then a ``"kill"``.  Lifetimes are drawn from
``default_rng((seed, worker, incarnation))``, so a given worker's k-th
incarnation always lives the same number of rounds; ``kill_shard_at``
additionally forces a kill at an exact round of a specific shard's first
attempt — the fully thread-insensitive form the tests pin.

The executor translates ``"kill"`` into :class:`Preempted` (raised out of
the build at the round boundary, carrying the last saved checkpoint) and
``"notice"`` into a known-remaining-lifetime mark that the time-based
re-admission policy consumes (paper §IV: never assign a task an instance
cannot finish — here, in rounds).
"""

from __future__ import annotations

import threading

import numpy as np


class Preempted(Exception):
    """A shard build was killed at a round boundary by the injector.

    ``checkpoint`` is the last :class:`~repro_torch.fleet.ShardCheckpoint`
    saved before the kill (None if the build died before its first
    checkpoint — the restart-from-zero case); ``worker`` identifies the
    lost instance.
    """

    def __init__(self, checkpoint=None, worker: int | None = None,
                 shard: int | None = None, lost_rounds: int = 0):
        self.checkpoint = checkpoint
        self.worker = worker
        self.shard = shard
        self.lost_rounds = lost_rounds  # rounds since the last checkpoint
        at = "round 0" if checkpoint is None else \
            f"round {checkpoint.round_idx}/{checkpoint.n_rounds_total}"
        super().__init__(
            f"worker {worker} preempted building shard {shard} at {at} "
            f"({lost_rounds} round(s) of work lost)"
        )


class PreemptionInjector:
    """Seeded per-instance lifetimes + explicit per-shard kill overrides.

    Parameters
    ----------
    mean_lifetime_rounds:
        Mean of the exponential lifetime draw, in completed rounds
        (None → instances never die on their own; only ``kill_shard_at``
        fires).  Mirrors ``make_spot_pool``'s exponential-after-safe-window
        model, with the safe window folded into the draw.
    notice_rounds:
        How many rounds of warning precede a seeded kill (§II-B's 5-minute
        notice, in round units).  Explicit ``kill_shard_at`` kills are
        notice-less, like a capacity crunch.
    kill_shard_at:
        ``{shard: round_idx}`` — kill the given shard's **first** attempt
        once it completes ``round_idx`` rounds, exactly once per shard.
    max_kills:
        Cap on total kills (seeded + explicit); None → unlimited.
    """

    def __init__(
        self,
        *,
        seed: int = 0,
        mean_lifetime_rounds: float | None = None,
        notice_rounds: int = 2,
        kill_shard_at: dict[int, int] | None = None,
        max_kills: int | None = None,
    ):
        self.seed = seed
        self.mean_lifetime_rounds = mean_lifetime_rounds
        self.notice_rounds = int(notice_rounds)
        self.kill_shard_at = dict(kill_shard_at or {})
        self.max_kills = max_kills
        self._lock = threading.Lock()
        self._incarnation: dict[int, int] = {}
        self._lifetime: dict[int, float] = {}
        self._rounds_run: dict[int, int] = {}
        self._killed_shards: set[int] = set()
        self.n_kills = 0
        self.n_notices = 0
        self.events: list[tuple] = []  # (kind, worker, shard, round_idx)

    def _draw_lifetime(self, worker: int, incarnation: int) -> float:
        if self.mean_lifetime_rounds is None:
            return float("inf")
        rng = np.random.default_rng((self.seed, worker, incarnation))
        return max(1.0, float(rng.exponential(self.mean_lifetime_rounds)))

    def start_instance(self, worker: int) -> None:
        """(Re)provision worker's slot: next incarnation, fresh seeded
        lifetime — the 'request a replacement spot instance' step."""
        with self._lock:
            inc = self._incarnation.get(worker, -1) + 1
            self._incarnation[worker] = inc
            self._lifetime[worker] = self._draw_lifetime(worker, inc)
            self._rounds_run[worker] = 0

    def lifetime_rounds(self, worker: int) -> float:
        with self._lock:
            if worker not in self._lifetime:
                raise KeyError(f"worker {worker} was never provisioned")
            return self._lifetime[worker]

    def known_remaining_rounds(self, worker: int) -> float | None:
        """Scheduler-visible remaining lifetime: None until the notice has
        fired (the provider keeps lifetimes secret until then)."""
        with self._lock:
            life = self._lifetime.get(worker, float("inf"))
            run = self._rounds_run.get(worker, 0)
            left = life - run
            return left if left <= self.notice_rounds else None

    def observe_round(
        self, worker: int, shard: int, attempt: int, round_idx: int
    ) -> str | None:
        """Advance worker's round clock; return ``"kill"`` / ``"notice"`` /
        None for the round that just completed."""
        with self._lock:
            if shard in self.kill_shard_at and attempt == 0 \
                    and shard not in self._killed_shards \
                    and round_idx >= self.kill_shard_at[shard] \
                    and (self.max_kills is None
                         or self.n_kills < self.max_kills):
                self._killed_shards.add(shard)
                self.n_kills += 1
                self.events.append(("kill", worker, shard, round_idx))
                return "kill"
            if worker not in self._rounds_run:  # unprovisioned: immortal
                return None
            self._rounds_run[worker] += 1
            left = self._lifetime[worker] - self._rounds_run[worker]
            if left <= 0 and (self.max_kills is None
                              or self.n_kills < self.max_kills):
                self.n_kills += 1
                self.events.append(("kill", worker, shard, round_idx))
                return "kill"
            if left <= self.notice_rounds:
                self.n_notices += 1
                self.events.append(("notice", worker, shard, round_idx))
                return "notice"
            return None
