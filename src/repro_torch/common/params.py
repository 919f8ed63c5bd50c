"""Declarative parameter trees (counterpart of ``repro/common/params.py``).

A model declares its parameters as a nested dict (and list) of :class:`P`
leaves, each a (shape, logical axes, init rule, dtype) record.  From that
one declaration come the concrete tensors (:func:`init_params`) and the
parameter count (:func:`param_count`).  The init rules are the reference's:
``scaled_normal`` draws with std ``scale / sqrt(fan_in)``, ``normal`` with
std ``scale``, ``embed`` with std ``0.02 * scale``, and ``ones``/``zeros``
fill.  Draws come from one ``torch.Generator`` on the target device, so a
1.1B-parameter model is made on the card without a host round trip; the
numbers differ from ``jax.random``'s for the same seed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Tree = Any

LAYER_AXIS = "layers"  # leading axis added by `stack`


@dataclasses.dataclass(frozen=True)
class P:
    """A single parameter declaration.

    Attributes:
      shape: parameter shape.
      axes: logical axis names, one per dim (``None`` entries are unsharded).
      init: one of 'normal', 'scaled_normal', 'zeros', 'ones', 'embed'.
      dtype: overrides the tree-level param dtype when set.
      scale: stddev multiplier for normal inits.
      fan_in_axes: dims whose product is the fan-in for 'scaled_normal'.
    """

    shape: tuple
    axes: tuple
    init: str = "scaled_normal"
    dtype: Any = None
    scale: float = 1.0
    fan_in_axes: tuple = (0,)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"shape {self.shape} and axes {self.axes} rank mismatch"
            )


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` to the leaves of nested dicts and lists (in key order),
    zipping any further trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *r) for t, *r in zip(tree, *rest)]
    return fn(tree, *rest)


def leaves(tree: Tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def leaves_with_paths(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(dot.path, leaf)]`` in the order of :func:`leaves`."""
    if isinstance(tree, dict):
        return [pl for k in tree
                for pl in leaves_with_paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree)
                for pl in leaves_with_paths(t, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def _init_one(p: P, gen: torch.Generator, dtype, device) -> torch.Tensor:
    dtype = p.dtype or dtype
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "normal":
        std = p.scale
    elif p.init == "embed":
        std = 0.02 * p.scale
    elif p.init == "scaled_normal":
        fan_in = max(1, math.prod(p.shape[a] for a in p.fan_in_axes))
        std = p.scale / math.sqrt(fan_in)
    else:
        raise ValueError(f"unknown init {p.init!r}")
    x = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)


def init_params(tree: Tree, seed: int = 0, *, dtype=torch.float32,
                device=None) -> Tree:
    """Concrete tensors for a declaration tree, drawn leaf by leaf (in
    :func:`leaves` order) from one generator seeded with ``seed`` on
    ``device``."""
    device = torch.device(device or "cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    return tree_map(lambda p: _init_one(p, gen, dtype, device), tree)


def param_count(tree: Tree) -> int:
    return int(sum(math.prod(p.shape) for p in leaves(tree)))


def stack(tree: Tree, n: int) -> Tree:
    """Add a leading `layers` axis of size `n` to every leaf."""

    def _stack(p: P) -> P:
        return dataclasses.replace(
            p,
            shape=(n, *p.shape),
            axes=(LAYER_AXIS, *p.axes),
            fan_in_axes=tuple(a + 1 for a in p.fan_in_axes),
        )

    return tree_map(_stack, tree)
