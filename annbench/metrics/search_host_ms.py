"""Milliseconds of a ``search()`` call in which the host does not wait on
the card: the window's ``search.engine`` spans less the ``search.wait``
spans inside them, over the number of ``search.engine`` spans.  Every
call ends in a wait, so this is host time the card cannot overlap.  A
wait outside any call (a build's live search) is not the call's; the
spans carry no parent ids, so a wait is a call's when it lies within it
(a cell's calls run one at a time)."""

import bisect


def read(r: dict):
    spans = r.get("spans", [])
    calls = sorted((s, e) for n, s, e in spans if n == "search.engine")
    starts = [s for s, _ in calls]
    wait, n_wait = 0, 0
    for n, s, e in spans:
        if n != "search.wait":
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= calls[i][1]:
            wait += e - s
            n_wait += 1
    if not calls or not n_wait:
        return None
    return 1e3 * (sum(e - s for s, e in calls) - wait) / 1e9 / len(calls)
