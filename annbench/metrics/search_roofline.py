"""Share of the roofline that the window's searches reach, in %: the least
time of their work on one H100 (``annbench/roofline.py``, from each call's
shape and ``SearchStats`` counts) over the device time of the ``search()``
calls, from CUDA events recorded on the stream around each call."""

from annbench.roofline import search_least_s


def read(r: dict):
    calls, secs = r.get("search_calls"), r.get("event_s")
    if not calls or not secs or len(calls) != len(secs):
        return None
    sh = r["shape"]
    least = sum(search_least_s(q=q, d=sh["d"], n=sh["n"], r=sh["r"],
                               k=sh["k"], nd=nd, hops=hops)
                for q, nd, hops in calls)
    return 100.0 * least / sum(secs)
