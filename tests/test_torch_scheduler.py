"""The port's scheduler and cost model (``repro_torch.core.scheduler``,
``repro_torch.core.cost_model``) against the JAX package's, on the CPU.

Every scenario of the reference's ``tests/test_scheduler.py`` runs through
both packages' virtual-clock ``Scheduler`` and must give equal
``SimResult``s (``dataclasses.asdict``: makespan, busy and wall seconds,
preemptions, restarts, speculative copies, lost work, the task log and
per-instance busy time), and equal task and instance end states.  An
unschedulable pool raises in both.  ``calibrate_runtime`` with an
injected timer gives an equal ``RuntimeModel``, over a fake build and over
the real default builds (the reference's ``numpy`` Vamana against the
port's on the CPU).  Every cost-model function agrees over a small grid.
"""

import dataclasses
import math

import numpy as np
import pytest

from repro.core import cost_model as jcost_model
from repro.core import scheduler as jscheduler
from repro_torch.core import cost_model, scheduler


def _availability(m):
    return [m.Scheduler(m.make_tasks([1000] * 8), m.make_ondemand_pool(2),
                        m.RuntimeModel(1e-3))]


def _time_based(m):
    itype = m.InstanceType("spot", 1.0, safe_duration_s=5.0, notice_s=1.0)
    pool = [m.Instance(iid=0, itype=itype, launched_at=0.0, lifetime_s=5.0),
            m.Instance(iid=1, itype=m.V100_ONDEMAND, launched_at=0.0)]
    return [m.Scheduler(m.make_tasks([30_000]), pool, m.RuntimeModel(1e-3))]


def _preemption_with_notice(m):
    itype = m.InstanceType("spot", 1.0, safe_duration_s=0.0, notice_s=1e9)
    pool = [m.Instance(iid=0, itype=itype, launched_at=0.0, lifetime_s=2.0),
            m.Instance(iid=1, itype=m.V100_ONDEMAND, launched_at=0.0)]
    return [m.Scheduler(m.make_tasks([10_000]), pool, m.RuntimeModel(1e-3))]


def _dying_pool(m):
    itype = m.InstanceType("spot", 1.0, safe_duration_s=3600.0, notice_s=0.0)
    return [m.Instance(iid=0, itype=itype, launched_at=0.0, lifetime_s=5.0),
            m.Instance(iid=1, itype=m.V100_ONDEMAND, launched_at=0.0)]


def _preemption_without_notice(m):
    return [m.Scheduler(m.make_tasks([10_000]), _dying_pool(m),
                        m.RuntimeModel(1e-3))]


def _checkpoint_resume(m):
    rm = m.RuntimeModel(1e-3)
    return [m.Scheduler(m.make_tasks([10_000]), _dying_pool(m), rm),
            m.Scheduler(m.make_tasks([10_000]), _dying_pool(m), rm,
                        checkpoint_resume=True, checkpoint_interval_s=1.0)]


def _stragglers(m):
    def slow(iid, tid):
        return 6.0 if tid == 2 else 1.0

    rm = m.RuntimeModel(1e-3)
    return [m.Scheduler(m.make_tasks([1000] * 16), m.make_ondemand_pool(4),
                        rm, straggler_factor=1.5, slowdown=slow),
            m.Scheduler(m.make_tasks([1000] * 16), m.make_ondemand_pool(4),
                        rm, slowdown=slow)]


def _heterogeneous(m):
    fast_cheap = m.InstanceType("a", price_per_hour=1.0, speed=2.0,
                                safe_duration_s=math.inf, notice_s=0.0)
    slow_pricey = m.InstanceType("b", price_per_hour=4.0, speed=1.0,
                                 safe_duration_s=math.inf, notice_s=0.0)
    pool = [m.Instance(iid=0, itype=slow_pricey, launched_at=0.0),
            m.Instance(iid=1, itype=fast_cheap, launched_at=0.0)]
    return [m.Scheduler(m.make_tasks([1000, 3000, 2000]), pool,
                        m.RuntimeModel(1e-3))]


def _spot_vs_ondemand(m):
    pool = [m.Instance(iid=0, itype=m.V100_ONDEMAND, launched_at=0.0),
            m.Instance(iid=1, itype=m.V100_SPOT, launched_at=0.0,
                       lifetime_s=1e9)]
    spot = m.make_spot_pool(3, mean_lifetime_s=600.0, seed=4)
    spot[0] = dataclasses.replace(spot[0], lifetime_s=900.0)
    return [m.Scheduler(m.make_tasks([1000]), pool, m.RuntimeModel(1e-3)),
            m.Scheduler(m.make_tasks([900_000, 2_000_000, 400_000, 50_000]),
                        spot + m.make_ondemand_pool(1), m.RuntimeModel(1e-3),
                        checkpoint_resume=True)]


def _cost_greedy_and_edd(m):
    rm = m.RuntimeModel(1e-3)
    fast_pricey = m.InstanceType("fast", price_per_hour=9.0, speed=3.0,
                                 safe_duration_s=math.inf, notice_s=0.0)
    slow_cheap = m.InstanceType("slow", price_per_hour=1.0, speed=1.0,
                                safe_duration_s=math.inf, notice_s=0.0)

    def pool():
        return [m.Instance(iid=0, itype=slow_cheap, launched_at=0.0),
                m.Instance(iid=1, itype=fast_pricey, launched_at=0.0)]

    def tasks():
        return [m.Task(tid=0, shard=0, size=9_000, deadline_s=100.0),
                m.Task(tid=1, shard=1, size=1_000, deadline_s=1.5)]

    return [m.Scheduler(tasks(), m.make_ondemand_pool(1), rm),
            m.Scheduler(tasks(), m.make_ondemand_pool(1), rm,
                        policy=m.DeadlinePolicy()),
            m.Scheduler(m.make_tasks([1000]), pool(), rm,
                        policy=m.DeadlinePolicy()),
            m.Scheduler(m.make_tasks([1000]), pool(), rm,
                        policy=m.CostGreedyPolicy())]


def _scale_4096(m):
    sizes = list(np.random.default_rng(0).integers(10_000, 100_000, 4096))
    return [m.Scheduler(m.make_tasks(sizes), m.make_ondemand_pool(4096),
                        m.RuntimeModel(1e-3))]


def _multi_worker(m):
    return [m.Scheduler(m.make_tasks([5_000] * 16), m.make_ondemand_pool(w),
                        m.RuntimeModel(1e-3)) for w in (1, 2, 4)]


SCENARIOS = {
    "availability": _availability,
    "time_based": _time_based,
    "preemption_with_notice": _preemption_with_notice,
    "preemption_without_notice": _preemption_without_notice,
    "checkpoint_resume": _checkpoint_resume,
    "stragglers": _stragglers,
    "heterogeneous_pool": _heterogeneous,
    "spot_vs_ondemand": _spot_vs_ondemand,
    "cost_greedy_and_edd": _cost_greedy_and_edd,
    "scale_4096": _scale_4096,
    "multi_worker": _multi_worker,
}


def _end_state(sch):
    return ([dataclasses.asdict(t) for t in sch.tasks.values()],
            [dataclasses.asdict(i) for i in sch.instances.values()])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_simulation_matches_reference(name):
    mine = SCENARIOS[name](scheduler)
    theirs = SCENARIOS[name](jscheduler)
    for a, b in zip(mine, theirs):
        got, want = a.run(), b.run()
        assert isinstance(got, scheduler.SimResult)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert _end_state(a) == _end_state(b)
        assert got.makespan_s > 0


@pytest.mark.parametrize("m", [scheduler, jscheduler],
                         ids=["port", "reference"])
def test_unschedulable_raises(m):
    itype = m.InstanceType("spot", 1.0, safe_duration_s=1.0, notice_s=1e9)
    pool = [m.Instance(iid=0, itype=itype, launched_at=0.0, lifetime_s=1.0)]
    with pytest.raises(RuntimeError, match="unschedulable"):
        m.Scheduler(m.make_tasks([100_000]), pool, m.RuntimeModel(1e-3)).run()


def test_calibrate_with_injected_timer_matches_reference():
    models = []
    for m in (scheduler, jscheduler):
        clock = [0.0]

        def fake_build(data):
            clock[0] += 2e-4 * len(data) + 0.05

        data = np.zeros((4096, 8), np.float32)
        models.append(m.calibrate_runtime(fake_build, data,
                                          (256, 512, 1024),
                                          timer=lambda: clock[0], seed=3))
    assert dataclasses.asdict(models[0]) == dataclasses.asdict(models[1])
    assert models[0].seconds_per_vector == pytest.approx(2e-4, rel=0.05)


def test_calibrate_default_builds_match_reference():
    """``build_fn=None``: the warm-up and the three sample builds run for
    real in both packages (numpy Vamana; the port's on the CPU); a timer
    that reads the sample sizes the builds drew gives equal models."""
    data = np.random.default_rng(0).normal(size=(600, 8)).astype(np.float32)
    models = []
    for m, kw in ((scheduler, dict(device="cpu")), (jscheduler, {})):
        ticks = iter(np.cumsum([0.0, 0.1, 0.2, 0.3, 0.5, 0.6, 0.9]))
        models.append(m.calibrate_runtime(None, data, (64, 128, 256),
                                          backend="numpy",
                                          timer=lambda: next(ticks), **kw))
    assert dataclasses.asdict(models[0]) == dataclasses.asdict(models[1])
    assert models[0].estimate(10_000, scheduler.V100_SPOT) > \
        models[0].estimate(1_000, scheduler.V100_SPOT)


def test_calibrate_on_the_cpu_fits_real_builds():
    data = np.random.default_rng(0).normal(size=(600, 8)).astype(np.float32)
    rm = scheduler.calibrate_runtime(None, data, (64, 128, 256),
                                     backend="torch", device="cpu")
    assert rm.seconds_per_vector > 0 and np.isfinite(rm.fixed_overhead_s)


def test_cost_model_matches_reference():
    assert cost_model.paper_example() == jcost_model.paper_example()
    ex = cost_model.paper_example()
    assert ex["diskann_cost"] == pytest.approx(67.3, abs=0.5)
    assert ex["scalegann_cost"] == pytest.approx(11.1, abs=0.5)
    pairs = ((scheduler.CPU_MACHINE, scheduler.V100_SPOT),
             (scheduler.CPU_MACHINE, scheduler.V100_ONDEMAND))
    jpairs = ((jscheduler.CPU_MACHINE, jscheduler.V100_SPOT),
              (jscheduler.CPU_MACHINE, jscheduler.V100_ONDEMAND))
    for wall in (0.0, 1.5, 3600.0, 62109.0):
        for active in (0.0, 12.25, 1800.0):
            for shards, nbytes, gbps in ((1, 0.0, 10.0), (16, 16e6, 10.0),
                                         (100, 16e9, 25.0)):
                assert cost_model.transfer_time_s(shards, nbytes, gbps) == \
                    jcost_model.transfer_time_s(shards, nbytes, gbps)
                for (cpu, acc), (jcpu, jacc) in zip(pairs, jpairs):
                    got = cost_model.fleet_cost(
                        wall, active, shards, nbytes, cpu=cpu, accel=acc,
                        bandwidth_gbps=gbps)
                    want = jcost_model.fleet_cost(
                        wall, active, shards, nbytes, cpu=jcpu, accel=jacc,
                        bandwidth_gbps=gbps)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want)
                    assert got.total == want.total
                    xfer = cost_model.transfer_time_s(shards, nbytes, gbps)
                    assert dataclasses.asdict(cost_model.scalegann_cost(
                        wall, active, xfer, cpu=cpu, accel=acc)) == \
                        dataclasses.asdict(jcost_model.scalegann_cost(
                            wall, active, xfer, cpu=jcpu, accel=jacc))
            for price in (None, 3.9):
                assert dataclasses.asdict(cost_model.cpu_only_cost(
                    wall, price_override=price)) == dataclasses.asdict(
                    jcost_model.cpu_only_cost(wall, price_override=price))


def test_instance_types_match_reference():
    for name in ("V100_SPOT", "V100_ONDEMAND", "CPU_MACHINE"):
        assert dataclasses.asdict(getattr(scheduler, name)) == \
            dataclasses.asdict(getattr(jscheduler, name))
    assert sorted(scheduler.SCHEDULING_POLICIES) == \
        sorted(jscheduler.SCHEDULING_POLICIES)
