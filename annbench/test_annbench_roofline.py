"""The frozen roofline arithmetic against hand counts."""

import pytest

from annbench import roofline


def test_search_work_by_hand():
    # 2 queries, d 4, 10 points, 3 slots a row, k 2; 6 distances, 2 hops
    b, ops = roofline.search_work(q=2, d=4, n=10, r=3, k=2, nd=6, hops=2)
    assert ops == 2 * 6 * 4
    assert b == (6 * 4 * 4          # six gathered rows of 16 bytes
                 + 2 * 3 * 4        # two graph rows of 12 bytes
                 + 2 * 4 * 4        # the queries
                 + 2 * 2 * 8        # ids and distances out
                 + 3 * 2 * 4)       # three counters a query


def test_gathers_count_no_more_than_the_store_holds():
    b, _ = roofline.search_work(q=1, d=4, n=10, r=3, k=1, nd=1000,
                                hops=1000)
    assert b == 10 * 4 * 4 + 10 * 3 * 4 + 4 * 4 + 8 + 12


def test_least_time_is_the_larger_bound():
    t, by = roofline.least_s(3.35e12, 1.0)
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = roofline.least_s(1.0, 2 * 67e12)
    assert (t, by) == (pytest.approx(2.0), "operations")
    assert roofline.search_least_s(q=1, d=1, n=1, r=1, k=1, nd=0,
                                   hops=0) == pytest.approx(
        (4 + 8 + 12) / 3.35e12)
