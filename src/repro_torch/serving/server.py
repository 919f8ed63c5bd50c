"""`AnnServer` — the asyncio micro-batching ANN query server (counterpart of
``repro/serving/server.py``).

The layer between "many single-query users" and the engine's batch lanes:
one query per ``search`` call leaves nearly all of the card's lanes idle,
and filling them is a front-end concern:

  submit() ──► RequestQueue (bounded admission) ──► MicroBatcher
      ▲                                                 │ flush on
      │ future resolved                                 │ max_batch /
      │                                                 ▼ max_wait_ms
  QueryResult ◄── worker ──► repro_torch.search.search(batch, backend=…)

One worker drains batches into the engine (off-loop in an executor thread,
so arrivals keep flowing while the engine computes), resolves each
request's future, and feeds :class:`~repro_torch.serving.stats.ServerStats`.
Batch shapes are padded to powers of two (:func:`bucket_batch_size`) and
warmed at startup.  The port has no jit, so what a first call of a path
pays is its kernels' ``nvcc`` builds and the ``fused`` backend's device
copies (store, graph, the kernel's per-row constants, the quantized
views); the warm-up leaves none of them to the first real request.

Not to be confused with ``repro_torch.serve`` — the *LM decode* serving
engine.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import time
from typing import Any

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.search import (DEFAULT_RERANK, as_topology, get_backend,
                                parse_dtype, parse_nprobe, search)
from repro_torch.serving.policy import AdaptiveWindow, FixedWindow, SLOPolicy
from repro_torch.serving.queue import (MicroBatcher, PendingRequest,
                                       RequestQueue, ServerOverloadedError)
from repro_torch.serving.stats import ServerStats
from repro_torch.telemetry import (SignatureGuard, collect_stages,
                                   current_tracer, install_compile_listener)

# sentinel: "use the server-level default" for per-request options
USE_DEFAULT = object()

# distinguishes trace-lane ids across servers in one process (a script runs
# several trials; request ids restart at 0 but lane keys must not collide)
_SERVER_SEQ = itertools.count()

_POST_WARM_METRIC = (
    "serving_post_warm_signatures_total",
    "engine-call signatures first seen after warm-up "
    "(mid-traffic retrace risk)",
)

_GENERATION_METRIC = (
    "serving_topology_generation",
    "current served topology generation (bumped by swap_topology)",
)


def bucket_batch_size(m: int, max_batch: int) -> int:
    """Engine-call batch shape for ``m`` real requests: the next power of
    two, capped at ``max_batch``.

    Powers of two keep the shape set to ``log2(max_batch)+1`` — small
    enough to warm at startup — and pad lanes cycle real queries and are
    sliced off, so padding changes no result."""
    if m <= 1:
        return 1
    return min(1 << (m - 1).bit_length(), max_batch)


@dataclasses.dataclass
class ServingConfig:
    """Knobs for :class:`AnnServer`, as in the reference.

    Engine side (passed straight to :func:`repro_torch.search.search`):
    ``k``, ``width``, ``n_entries``, ``backend`` (``"fused"`` by default,
    as ``search``'s; the reference's default ``"jax"`` has ``"torch"`` as
    its counterpart), ``nprobe``, ``metric``, ``dtype`` (distance stage:
    ``"f32"``/``"bf16"``/``"uint8"``) and ``rerank``.

    Batching side: a batch flushes at ``max_batch`` requests or when its
    oldest request has waited ``max_wait_ms`` — whichever trips first
    (``adaptive_window=True`` swaps the fixed window for
    :class:`~repro_torch.serving.policy.AdaptiveWindow`).  ``max_pending``
    bounds admitted-but-unserved requests; past it, ``admission="reject"``
    errors the submitter and ``"shed"`` errors the oldest queued request.
    ``bucket_batches`` pads engine calls to power-of-two sizes (cycling
    real queries), and ``pretrace`` warms all of them before the first
    real batch (requests submitted meanwhile just queue).
    ``pretrace_dtypes`` extends the warm-up to the listed distance stages
    × bucket sizes, as in the reference.  ``pretrace_nprobes`` (the port's
    addition; empty by default, so the default warm-up is the
    reference's) does the same for ``nprobe`` overrides a deployment
    accepts, e.g. ``("auto",)``: without it, each first override of a
    bucket is a signature first seen after warm-up.
    """

    k: int = 10
    width: int = 64
    n_entries: int = 16
    backend: str = "fused"
    nprobe: Any = None  # NprobeSpec: int, "auto", ("auto", margin), None
    dtype: str = "f32"  # distance stage; per-request overridable
    rerank: int = DEFAULT_RERANK  # staged dtypes re-rank rerank·k exactly
    metric: str | None = None
    max_batch: int = 64
    max_wait_ms: float = 2.0
    max_pending: int = 4096
    admission: str = "reject"
    adaptive_window: bool = False
    bucket_batches: bool = True
    pretrace: bool = True  # warm every bucketed shape before serving
    pretrace_dtypes: tuple = ()  # extra distance stages to warm (×buckets)
    pretrace_nprobes: tuple = ()  # extra nprobe specs to warm (×buckets)
    run_in_executor: bool = True  # False: call the engine on the loop


@dataclasses.dataclass
class QueryResult:
    """What a ``submit()`` future resolves to."""

    ids: np.ndarray  # [k] int64, -1 padded
    latency_s: float  # end-to-end: submit → future resolution
    batch_size: int  # real occupancy of the engine call that served it
    # (a flush splits into one engine call per distinct option pair, so
    # this can be smaller than the flush size)


class AnnServer:
    """Async micro-batching front-end over :func:`repro_torch.search.search`.

    Usage::

        async with AnnServer(topology) as srv:              # on the card
            res = await srv.submit(query_vector)
            # res.ids, res.latency_s

    Accepts everything ``search`` accepts as a target — a topology, a bare
    ``GlobalIndex`` + ``data``, or ``(ids, graphs)`` + ``data``.
    ``submit`` may carry per-request ``nprobe`` and ``dtype`` overrides; the
    worker groups a flushed batch by the ``(nprobe, dtype)`` pair so mixed
    batches still make one engine call per distinct option set.

    ``device`` is where the engine runs, resolved once here: the card
    unless ``"cpu"`` is given (the kernels' plain versions), and without
    CUDA the constructor raises rather than serve on the CPU.

    ``tracer`` (default: the process-wide :func:`current_tracer`) draws
    every request as an async lane on the timeline — submit → queue wait
    → batch assembly → engine → rerank → future resolution, keyed by
    request id.  The tracer's clock **must share the server's** (pass
    ``Tracer(clock=time.monotonic)`` for the default server clock).  With
    the default no-op tracer the hot path pays a single ``enabled`` branch
    per request.
    """

    def __init__(self, index_or_shards, config: ServingConfig | None = None,
                 *, data: np.ndarray | None = None,
                 policy: SLOPolicy | None = None, clock=time.monotonic,
                 tracer=None, device=None):
        self.config = cfg = config or ServingConfig()
        self.topology = as_topology(index_or_shards, data,
                                    metric=cfg.metric or "l2")
        if cfg.metric is not None and self.topology.metric != cfg.metric:
            # caller passed a prebuilt topology with a different metric
            self.topology = dataclasses.replace(self.topology,
                                                metric=cfg.metric)
        parse_nprobe(cfg.nprobe)  # fail fast on a bad default spec
        for npb in cfg.pretrace_nprobes:  # ...a bad extra warm-up spec
            parse_nprobe(npb)
        parse_dtype(cfg.dtype)  # ...a bad distance stage
        for dt in cfg.pretrace_dtypes:  # ...a bad extra warm-up stage
            parse_dtype(dt)
        get_backend(cfg.backend)  # ...and on an unknown backend name
        if cfg.width < cfg.k:  # ...and before search() would refuse it
            raise ValueError(
                f"width ({cfg.width}) must be >= k ({cfg.k})"
            )
        self.device = resolve_device(device)
        self.stats = ServerStats()
        self.clock = clock
        self.tracer = current_tracer() if tracer is None else tracer
        self._scope = next(_SERVER_SEQ)
        self._rids = itertools.count()
        self._sig_guard = SignatureGuard()
        self.stats.registry.counter(*_POST_WARM_METRIC)  # expose at zero
        # kernel builds land in the current registry (and on the tracer's
        # timeline) whenever they happen; installing is idempotent
        install_compile_listener()
        if policy is None:
            policy = (AdaptiveWindow(cfg.max_wait_ms, cfg.max_batch)
                      if cfg.adaptive_window else FixedWindow(cfg.max_wait_ms))
        self.policy = policy
        self._batcher = MicroBatcher(cfg.max_batch, cfg.max_wait_ms / 1e3)
        self._queue = RequestQueue(self._batcher, cfg.max_pending,
                                   admission=cfg.admission, clock=clock)
        self._worker_task: asyncio.Task | None = None
        self._inflight: list[PendingRequest] = []  # batch popped, unresolved
        self._dim = int(np.asarray(self.topology.data).shape[1])
        self._executing = None  # the topology the running batch reads
        self.topology_generation = 0
        self.stats.registry.gauge(*_GENERATION_METRIC).set(0)

    # ---- live topology swap ---------------------------------------------

    def swap_topology(self, index_or_shards, *,
                      data: np.ndarray | None = None,
                      reason: str | None = None) -> int:
        """Atomically swap the served topology (epoch swap), as in the
        reference: one attribute store, read once per engine batch, so
        every batch answers against one generation and no request is
        rejected or replayed across a swap.

        The ``fused`` backend's device copies are keyed on the host arrays'
        identities, so a new topology over the same arrays (a merged
        topology's f32 store, a live index snapshot's untouched shards)
        reuses its copies.  With ``pretrace`` on, the swap warms the new
        topology at the warmed dtypes before it stores it, in the caller's
        thread: what is new (a mutated shard's arrays, a topology's own
        quantized views) uploads here and not inside a batch's engine
        time, and the cache keeps room for the generations still read
        (the served one, and the executing batch's).
        ``reason`` labels the swap in metrics and the trace.  Returns the
        new generation number.
        """
        topo = as_topology(index_or_shards, data,
                           metric=self.config.metric or "l2")
        dim = int(np.asarray(topo.data).shape[1])
        if dim != self._dim:
            raise ValueError(
                f"swapped topology dim {dim} != served dim {self._dim}"
            )
        if topo.metric != self.topology.metric:
            raise ValueError(
                f"swapped topology metric {topo.metric!r} != served "
                f"{self.topology.metric!r}"
            )
        warm = getattr(get_backend(self.config.backend), "warm", None)
        if self.config.pretrace and warm is not None:
            # the generations still read: the served one, and the one the
            # executing batch read when it started (one batch at a time)
            keep = {id(t): t for t in (self.topology, self._executing)
                    if t is not None}
            warm(topo, self._warm_dtypes(), self.device,
                 keep=tuple(keep.values()))
        self.topology = topo  # the swap: one atomic attribute store
        self.topology_generation += 1
        self.stats.registry.gauge(*_GENERATION_METRIC).set(
            self.topology_generation
        )
        self.stats.registry.counter(
            "serving_topology_swaps_total", "epoch swaps served",
            reason=reason or "unspecified",
        ).inc()
        if self.tracer.enabled:
            self.tracer.instant("serve.epoch_swap", track="serving",
                                generation=self.topology_generation,
                                reason=reason or "unspecified")
        return self.topology_generation

    # ---- lifecycle ------------------------------------------------------

    async def __aenter__(self) -> "AnnServer":
        self.start()
        return self

    async def __aexit__(self, exc_type, exc, tb) -> None:
        await self.stop()

    def start(self) -> None:
        if self._worker_task is not None:
            raise RuntimeError("server already started")
        self._worker_task = asyncio.get_running_loop().create_task(
            self._worker(), name="repro_torch.serving.worker"
        )

    async def stop(self) -> None:
        """Drain: stop admitting, serve everything already queued, join."""
        if self._worker_task is None:
            return
        self._queue.close()
        task, self._worker_task = self._worker_task, None
        await task

    @property
    def depth(self) -> int:
        """Admitted-but-unserved requests (the SLO policy's input)."""
        return self._queue.depth()

    # ---- submission -----------------------------------------------------

    def submit_nowait(self, query: np.ndarray, *,
                      nprobe: Any = USE_DEFAULT,
                      dtype: Any = USE_DEFAULT,
                      t_submit: float | None = None) -> asyncio.Future:
        """Enqueue one query; returns the future (no await).

        ``nprobe`` / ``dtype`` override the server defaults per request.
        ``t_submit`` backdates the request for open-loop measurement: a
        load generator that fell behind the arrival schedule charges the
        slip to the request's latency, as a real network arrival would.
        Raises :class:`ServerOverloadedError` when the bounded queue is
        full under the ``"reject"`` policy.
        """
        task = self._worker_task
        if task is None:
            raise RuntimeError(
                "server not started — use `async with AnnServer(...)` or "
                "call start() from a running event loop"
            )
        if task.done():  # crashed (a healthy worker runs until stop())
            exc = None if task.cancelled() else task.exception()
            raise RuntimeError("serving worker is no longer running") \
                from exc
        q = np.asarray(query, np.float32)
        if q.ndim != 1 or q.shape[0] != self._dim:
            raise ValueError(
                f"query must be a [{self._dim}] vector, got shape {q.shape}"
            )
        if nprobe is not USE_DEFAULT:
            parse_nprobe(nprobe)  # fail in the caller, not the worker
        if dtype is not USE_DEFAULT:
            parse_dtype(dtype)
        fut = asyncio.get_running_loop().create_future()
        req = PendingRequest(
            query=q, future=fut,
            t_submit=self.clock() if t_submit is None else t_submit,
            nprobe=self.config.nprobe if nprobe is USE_DEFAULT else nprobe,
            dtype=self.config.dtype if dtype is USE_DEFAULT else dtype,
            rid=next(self._rids),
        )
        try:
            shed = self._queue.submit(req)
        except ServerOverloadedError:
            self.stats.record_rejected()
            raise
        if shed is not None:
            self.stats.record_shed()
        # retune the open batch's window from the new depth
        self._batcher.max_wait_s = (
            self.policy.window_ms(self._queue.depth()) / 1e3
        )
        return fut

    async def submit(self, query: np.ndarray, *,
                     nprobe: Any = USE_DEFAULT,
                     dtype: Any = USE_DEFAULT,
                     t_submit: float | None = None) -> QueryResult:
        """Submit one query and await its :class:`QueryResult`."""
        return await self.submit_nowait(query, nprobe=nprobe, dtype=dtype,
                                        t_submit=t_submit)

    # ---- the worker -----------------------------------------------------

    async def _worker(self) -> None:
        try:
            await self._serve_loop()
        except BaseException as e:
            # a dead worker must not leave futures hanging: fail the
            # in-flight batch (already popped from the queue — e.g. a
            # cancellation landed mid-executor-call) plus everything still
            # admitted, and surface e via stop() / submit
            n = self._queue.fail_all(e)
            for req in self._inflight:
                if not req.future.done():
                    req.future.set_exception(e)
                    n += 1
            self._inflight = []
            self.stats.record_failed(n)
            raise

    async def _serve_loop(self) -> None:
        # The engine runs in an executor thread: K3, K1 and K2 launch there
        # on torch.cuda.current_stream(dev), the default stream in that
        # thread as in any other.  The kernels' launch counters
        # (kernels._build.count) and K3's id-range cache (beam._CHECKED)
        # take locks of their own, so other threads may launch beside the
        # engine (a live index's writer); this loop still hands the engine
        # one batch at a time, after the warm-up has finished.
        loop = asyncio.get_running_loop()
        if self.config.pretrace and self.config.bucket_batches:
            # without bucketing the engine sees one shape per occupancy —
            # warming the power-of-two set would warm the wrong shapes
            await loop.run_in_executor(None, self._pretrace)
        # from here on, a first-seen engine-call signature is a first call
        # landing inside live traffic — exactly what the guard counts
        self._sig_guard.finish_warmup()
        while True:
            batch = await self._queue.next_batch()
            if batch is None:
                return
            t_flush = self.clock()
            for req in batch:
                req.t_flush = t_flush
            self._inflight = batch  # visible to the death handler
            try:
                if self.config.run_in_executor:
                    outs = await loop.run_in_executor(
                        None, self._execute, batch
                    )
                else:
                    outs = self._execute(batch)
            except Exception as e:  # engine failure: fail this batch only
                self.stats.record_failed(len(batch))
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)
                self._inflight = []
                continue
            now = self.clock()
            traced = self.tracer.enabled
            for req, (ids, group_size, t_eng0, t_eng1, rerank_s) in zip(
                    batch, outs):
                if req.future.done():  # submitter gave up (cancelled)
                    continue
                self.stats.record_completion(
                    req.t_submit, now,
                    queue_wait_s=req.t_flush - req.t_submit,
                    engine_s=t_eng1 - t_eng0,
                )
                req.future.set_result(QueryResult(
                    ids=ids, latency_s=max(now - req.t_submit, 0.0),
                    batch_size=group_size,
                ))
                if traced:
                    self._emit_request_trace(req, now, t_eng0, t_eng1,
                                             rerank_s)
            self._inflight = []

    def _emit_request_trace(self, req: PendingRequest, t_done: float,
                            t_eng0: float, t_eng1: float,
                            rerank_s: float) -> None:
        """One request's life as an async lane: the ``serve.request``
        parent plus contiguous child phases that tile it end to end
        (queue wait → batch assembly → engine → rerank → resolution), all
        keyed by the request id so overlapping requests render as
        separate lanes.  Timestamps are the server-clock readings the
        worker already took, so tracing adds no clock reads."""
        tr = self.tracer
        aid = f"srv{self._scope}:req{req.rid}"
        t_rr0 = max(t_eng1 - rerank_s, t_eng0)
        tr.async_complete("serve.request", aid, req.t_submit, t_done,
                          cat="serving", track="requests", rid=req.rid)
        tr.async_complete("serve.queue_wait", aid, req.t_submit,
                          req.t_flush, cat="serving", track="requests")
        tr.async_complete("serve.batch", aid, req.t_flush, t_eng0,
                          cat="serving", track="requests")
        tr.async_complete("serve.engine", aid, t_eng0, t_rr0,
                          cat="serving", track="requests")
        tr.async_complete("serve.rerank", aid, t_rr0, t_eng1,
                          cat="serving", track="requests")
        tr.async_complete("serve.resolve", aid, t_eng1, t_done,
                          cat="serving", track="requests")

    def _warm_dtypes(self) -> tuple:
        """The distance stages the warm-up covers, default first."""
        cfg = self.config
        return tuple(dict.fromkeys((cfg.dtype, *cfg.pretrace_dtypes)))

    def _pretrace(self) -> None:
        """Warm every batch shape the worker can produce (index vectors
        stand in for queries) at the config-default ``(nprobe, dtype)``,
        extended to ``pretrace_nprobes`` × ``pretrace_dtypes``.

        A backend with a ``warm`` hook (the ``fused`` one) first uploads
        every device copy a search of the topology at those dtypes reads —
        every shard of a split topology, whichever shards the warm-up
        queries route to — and sizes its cache to hold them all.  The
        searches then build any kernel not yet built.  So neither an
        ``nvcc`` build nor an upload is left to the first real request
        of a warmed signature."""
        cfg = self.config
        sizes = {bucket_batch_size(cfg.max_batch, cfg.max_batch)}
        b = 1
        while b < cfg.max_batch:
            sizes.add(b)
            b <<= 1
        dtypes = self._warm_dtypes()
        nprobes: dict = {}  # parsed spec -> the first spelling of it
        for npb in (cfg.nprobe, *cfg.pretrace_nprobes):
            nprobes.setdefault(parse_nprobe(npb), npb)
        warm = getattr(get_backend(cfg.backend), "warm", None)
        if warm is not None:
            warm(self.topology, dtypes, self.device)
        data = np.asarray(self.topology.data, np.float32)
        for size in sorted(sizes):
            qs = np.resize(data[: min(len(data), size)], (size, self._dim))
            for nprobe_key, nprobe in nprobes.items():
                for dtype in dtypes:
                    self._sig_guard.warm(
                        (cfg.backend, size, nprobe_key, dtype)
                    )
                    search(self.topology, qs, cfg.k, backend=cfg.backend,
                           width=cfg.width, n_entries=cfg.n_entries,
                           nprobe=nprobe, dtype=dtype, rerank=cfg.rerank,
                           device=self.device)

    def _execute(self, batch: list[PendingRequest]) -> list[tuple]:
        """One flushed batch → engine calls, grouped by the per-request
        ``(nprobe, dtype)`` option pair.

        Runs in an executor thread; touches no asyncio state.  Batches are
        bucket-padded by cycling real queries (the padded lanes recompute
        real work, so results are unaffected and stats can be rescaled).
        Each request's slot carries its engine call's ``(t0, t1)`` window
        and the exact-rerank share of it.  ``t1 - t0`` is the engine's
        time, the card's included, because ``search`` returns host numpy:
        the backends read their results back (``.cpu()``), which waits for
        the card.
        """
        cfg = self.config
        clk = self.clock
        # read the served topology ONCE per batch: swap_topology() may
        # replace the attribute concurrently (atomic store from the loop
        # thread), and every engine call in this flush must answer against
        # one consistent generation
        topo = self._executing = self.topology
        # key on the *parsed* nprobe spec so equivalent forms ("auto" vs
        # ("auto", DEFAULT_AUTO_MARGIN), 2 vs np.int64(2)) share one
        # engine call instead of splitting the batch; dtype is already
        # canonical after parse_dtype at submit time
        groups: dict[tuple, tuple[Any, str, list[int]]] = {}
        for i, req in enumerate(batch):
            key = (parse_nprobe(req.nprobe), req.dtype)
            groups.setdefault(key, (req.nprobe, req.dtype, []))[2].append(i)
        out: list[tuple | None] = [None] * len(batch)
        for key, (nprobe, dtype, idxs) in groups.items():
            queries = np.stack([batch[i].query for i in idxs])
            m = len(idxs)
            b = bucket_batch_size(m, cfg.max_batch) if cfg.bucket_batches \
                else m
            if b > m:
                queries = np.resize(queries, (b, queries.shape[1]))
            _, post_warm = self._sig_guard.observe((cfg.backend, b) + key)
            if post_warm:  # first-call risk: this shape was never warmed
                # resolved through the live stats object: a caller that
                # swaps self.stats for a fresh window keeps the count
                self.stats.registry.counter(*_POST_WARM_METRIC).inc()
                if self.tracer.enabled:
                    self.tracer.instant("serve.retrace_risk", track="jit",
                                        backend=cfg.backend, batch=b,
                                        dtype=dtype)
            t0 = clk()
            with collect_stages() as stages:
                ids, st = search(
                    topo, queries, cfg.k, backend=cfg.backend,
                    width=cfg.width, n_entries=cfg.n_entries, nprobe=nprobe,
                    dtype=dtype, rerank=cfg.rerank, device=self.device,
                )
            t1 = clk()
            self.stats.observe_batch(m, b, st, t1 - t0)
            rerank_s = stages.get("search.rerank", 0.0)
            for j, i in enumerate(idxs):
                out[i] = (ids[j], m, t0, t1, rerank_s)
        self._executing = None
        return out  # type: ignore[return-value]
