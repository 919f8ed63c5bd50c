"""What several metric readers share."""


def span_mean(r: dict, name: str):
    """Mean seconds of the window's spans called ``name``, or None."""
    d = [(e - s) / 1e9 for n, s, e in r.get("spans", []) if n == name]
    return sum(d) / len(d) if d else None
