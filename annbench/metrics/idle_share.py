"""Share of the traced window in which no operation ran on the card, in %
(the union of the profiler's device intervals).  One reader for
``idle_share.build`` and ``idle_share.search``."""


def read(r: dict):
    dev = r.get("device")
    if dev is None or dev["window_s"] <= 0 or dev["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
