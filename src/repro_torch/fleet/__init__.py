"""Preemption-tolerant spot-fleet build orchestration (paper §II-B, §IV;
counterpart of ``repro.fleet``).

The paper's headline — up to 9× faster indexing at ~6× lower cost — only
holds if shard builds *survive* spot preemptions.  This package is that
robustness layer:

* :class:`ShardCheckpoint` / :class:`CheckpointStore` — round-grain
  checkpoints of in-flight ``build_shard_index_vamana`` builds, resumed
  bit-compatibly (``repro_torch.core.vamana``'s ``round_hook`` /
  ``resume``), stored in a CRC32-checksummed envelope behind fsync'd
  atomic writes, in the reference's format — a corrupt or torn checkpoint
  is treated as missing (rebuild from round 0), never an executor crash;
* :class:`PreemptionInjector` / :class:`Preempted` — deterministic
  notice/kill delivery at round boundaries (seeded lifetimes, or explicit
  per-shard kills for tests);
* :func:`build_scalegann_fleet` — the real-build executor on the card:
  §IV availability/time-based re-admission, capped-backoff re-queue,
  pluggable :class:`SchedulingPolicy` (cost-greedy vs deadline/EDD —
  shared with the virtual-clock ``repro_torch.core.scheduler.Scheduler``),
  calibrated §VI-C cost reporting.
"""

from repro_torch.core.scheduler import (  # noqa: F401 — one policy namespace
    SCHEDULING_POLICIES,
    CostGreedyPolicy,
    DeadlinePolicy,
)
from repro_torch.fleet.checkpoint import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointStore,
    ShardCheckpoint,
)
from repro_torch.fleet.executor import (  # noqa: F401
    FleetBuildResult,
    FleetReport,
    ShardTimeline,
    build_scalegann_fleet,
)
from repro_torch.fleet.injector import (  # noqa: F401
    Preempted,
    PreemptionInjector,
)
