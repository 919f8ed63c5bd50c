"""One clock for the program's spans and the card's trace: a traced cell
lays the tracer's ``time.monotonic`` spans onto the profiler's wall-clock
device events with one offset read before the window
(``annbench/devtrace.py``).  Two ~2 ms sleep kernels, each launched and
waited for inside a span, 20 s apart under the profiler, must each lie
inside their span once converted as the harness converts them, ending at
most 0.2 ms before it.  They often do not: the device's times drift from
the host's by up to a few hundred microseconds over 20 s, by how much
depends on the machine (the ``xfail`` below), a fault of the harness's
alignment that the test keeps in view."""

import time

import pytest
import torch

from annbench import devtrace
from repro_torch.telemetry import Tracer

GAP_S = 20.0
SLEEP_CYCLES = 4_000_000  # ~2 ms at the H100's 1.98 GHz SM clock
END_SLACK_NS = 200_000


@pytest.mark.card
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
@pytest.mark.xfail(reason=(
    "the profiler's device times drift from the host's: on an H100 80GB "
    "HBM3 at 700 W the first sleep kernel lay 50-82 us after its span's "
    "start and the second, 20 s later, 153-381 us before it (two runs); "
    "on two other machines the shift over 20 s was 4 us (a pass) and "
    "116 us, so one offset read before a window does not hold to "
    "sub-millisecond gaps across it"))
def test_sleep_kernels_lie_inside_their_spans():
    card = torch.device("cuda")
    tracer = Tracer(clock=time.monotonic)
    offset = devtrace.wall_minus_monotonic_ns()
    with devtrace.profiled(True) as prof:
        # a short launch and wait first: the first of them under the
        # profiler returns ~0.8 ms late on an H100, the later ones do not
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(card)
        for i in range(2):
            if i:
                time.sleep(GAP_S)
            with tracer.span("clock.sleep"):
                torch.cuda._sleep(SLEEP_CYCLES)
                torch.cuda.synchronize(card)
    spans = devtrace.tracer_spans(tracer, offset)
    sleeps = [ev for ev in devtrace.device_events(prof)
              if ev[2] - ev[1] >= 1_000_000]
    assert len(spans) == len(sleeps) == 2, (spans, sleeps)
    gaps = [(ks - ss, se - ke) for (_, ks, ke), (_, ss, se)
            in zip(sleeps, spans)]
    print("kernel start after span start, span end after kernel end (ns):",
          gaps, "kernel and span lengths (ns):",
          [(ke - ks, se - ss) for (_, ks, ke), (_, ss, se)
           in zip(sleeps, spans)])
    for start_gap, end_gap in gaps:
        assert 0 <= start_gap and 0 <= end_gap <= END_SLACK_NS, gaps
