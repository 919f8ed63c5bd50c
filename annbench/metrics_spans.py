"""What the readers of the program's inner spans share: sums of the
window's spans by name, over the number of the spans that hold them."""


def seconds(r: dict, *names: str) -> tuple:
    """``(total seconds, count)`` of the window's spans called one of
    ``names``."""
    d = [(e - s) / 1e9 for n, s, e in r.get("spans", []) if n in names]
    return sum(d), len(d)


def per_parent(r: dict, children: tuple, parent: str):
    """Seconds of the window's ``children`` spans for each ``parent`` span,
    or None where either is missing (a program without those spans)."""
    total, n_children = seconds(r, *children)
    _, n_parents = seconds(r, parent)
    if not n_children or not n_parents:
        return None
    return total / n_parents
