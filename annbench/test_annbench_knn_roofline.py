"""K4's roofline share: its arithmetic by hand, and its reader on a made-up
record of K4 calls; nothing with no record, outside a build's ``shard.knn``
spans, or from a program that keeps no record.  A call recorded before the
window's ``reset_counts()`` is not the window's."""

import numpy as np
import pytest
import torch

from annbench import harness, roofline_knn
from repro_torch import kernels
from repro_torch.kernels import ops
from repro_torch.telemetry import Tracer, use_tracer

S = 10**9
BUILD = {"spans": [("build.shards", 0, 2 * S), ("shard.knn", 0, S)]}


def test_knn_work_by_hand():
    b, o = roofline_knn.knn_work(m=4096, n=156_250, d=128, k=129)
    assert b == (4096 + 156_250) * 128 * 4 + 4096 * 129 * 8
    assert o == 2 * 4096 * 156_250 * 128
    # 1.6384e11 FP32 operations at 67 TFLOP/s: the operations bound
    assert roofline_knn.knn_least_s(m=4096, n=156_250, d=128,
                                    k=129) == pytest.approx(o / 67e12)


def test_reader_by_hand(monkeypatch):
    calls = [(4096, 156_250, 128, 129, 7.83e-3),  # K4 at SIFT's main path
             (12_500, 12_500, 960, 129, 12e-3)]   # a GIST shard
    monkeypatch.setattr(kernels, "knn_launches", lambda: calls)
    least = (2 * 4096 * 156_250 * 128 + 2 * 12_500**2 * 960) / 67e12
    want = 100 * least / (7.83e-3 + 12e-3)  # 31.2% and 37.3%: 34.9%
    assert harness.reader("knn_roofline")(BUILD) == pytest.approx(want)


@pytest.mark.parametrize("calls,spans", [
    ([], BUILD["spans"]),                                  # no record
    ([(10, 10, 8, 4, 1e-3)], [("search.engine", 0, S)]),   # no shard build
], ids=["no_record", "no_shard_knn"])
def test_reader_reads_nothing(monkeypatch, calls, spans):
    monkeypatch.setattr(kernels, "knn_launches", lambda: calls)
    assert harness.reader("knn_roofline")({"spans": spans}) is None


def test_reader_of_an_older_program_reads_nothing(monkeypatch):
    monkeypatch.delattr(kernels, "knn_launches")
    assert harness.reader("knn_roofline")(BUILD) is None


def test_a_call_before_the_windows_reset_is_not_counted():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 16)).astype(np.float32))
    with use_tracer(Tracer()):
        ops.knn(x, x, 5)  # set-up's call
        kernels.reset_counts()  # the window opens
        ops.knn(x[:8], x, 5)
    calls = kernels.knn_launches()
    assert [c[:4] for c in calls] == [(8, 64, 16, 5)]
    want = 100 * roofline_knn.knn_least_s(m=8, n=64, d=16, k=5) / calls[0][4]
    assert harness.reader("knn_roofline")(BUILD) == pytest.approx(want)
    kernels.reset_counts()
