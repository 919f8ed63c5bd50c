"""Declarative parameter trees (counterpart of ``repro/common/params.py``).

A model declares its parameters as a nested dict (and list) of :class:`P`
leaves, each a (shape, logical axes, init rule, dtype) record.  From that
one declaration come the concrete tensors (:func:`init_params`), tensors
on the ``meta`` device that allocate nothing (:func:`abstract_params`, the
counterpart of the reference's ``ShapeDtypeStruct`` trees, which the
dry-run counts a step over), the logical-axis tree (:func:`logical_axes`,
resolved to shardings by :mod:`repro_torch.distributed.sharding`) and the
parameter count (:func:`param_count`).  The init rules are the reference's:
``scaled_normal`` draws with std ``scale / sqrt(fan_in)``, ``normal`` with
std ``scale``, ``embed`` with std ``0.02 * scale``, ``ones``/``zeros``
fill, and a callable ``init(gen, shape, dtype, device)`` makes the leaf
itself (the SSM's decay and step-size inits).  A leaf's declared ``dtype``
wins over the tree's.  Draws come from one ``torch.Generator`` on the
target device, in f32 pieces of at most :data:`INIT_PIECE` elements that
are scaled and written into the leaf in its own dtype, so a leaf larger
than the card's memory in f32 is made straight in bf16 (the pieces are the
same whatever the dtype: a bf16 init equals the f32 init of the same seed,
rounded).  The numbers differ from ``jax.random``'s for the same seed.
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
      init: one of 'normal', 'scaled_normal', 'zeros', 'ones', 'embed', or
        a callable ``(gen, shape, dtype, device) -> tensor``.
      dtype: overrides the tree-level param dtype when set.
      scale: stddev multiplier for normal inits.
      fan_in_axes: dims whose product is the fan-in for 'scaled_normal'.
    """

    shape: tuple
    axes: tuple
    init: Any = "scaled_normal"
    dtype: Any = None
    scale: float = 1.0
    fan_in_axes: tuple = (0,)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"shape {self.shape} and axes {self.axes} rank mismatch"
            )


_NODES: set = set()


def register_node(cls):
    """Class decorator: instances of the dataclass ``cls`` (a
    ``TrainState``) are walked field by field by :func:`tree_map` and
    :func:`leaves`, as ``jax.tree_util`` walks a registered node; any other
    dataclass (:class:`P`, a sharding) is a leaf."""
    _NODES.add(cls)
    return cls


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` to the leaves of nested dicts, lists, tuples and
    registered dataclasses (in key and field order), zipping any further
    trees of the same structure.  ``None`` is an empty subtree: it stays
    ``None`` and holds no leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *r) for t, *r in zip(tree, *rest)]
    if type(tree) in _NODES:
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def leaves(tree: Tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def unflatten(tree: Tree, leaves: list) -> Tree:
    """A tree shaped like ``tree`` holding ``leaves`` in :func:`leaves`
    order (each new leaf may itself be any object)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_map_p(fn: Callable, tree: Tree) -> Tree:
    """Apply ``fn`` to the :class:`P` leaves of ``tree``; other leaves stay
    as they are."""
    return tree_map(lambda x: fn(x) if isinstance(x, P) else x, tree)


def tree_map_with_paths(fn: Callable, tree: Tree, prefix: str = "") -> Tree:
    """Apply ``fn(dot.path, leaf)`` to the leaves of nested dicts and lists,
    with the paths of :func:`leaves_with_paths`."""
    if isinstance(tree, dict):
        return {k: tree_map_with_paths(fn, v, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_paths(fn, t, f"{prefix}{i}.")
                for i, t in enumerate(tree)]
    return fn(prefix[:-1], tree)


def leaves_with_paths(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(dot.path, leaf)]`` in the order of :func:`leaves`."""
    if isinstance(tree, dict):
        return [pl for k in tree
                for pl in leaves_with_paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree)
                for pl in leaves_with_paths(t, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def flatten_with_paths(tree: Tree) -> list[tuple[str, Any]]:
    """``[(dot.path, leaf)]`` in the reference's order (``jax.tree_util``
    flattens dict keys sorted; :func:`leaves_with_paths` keeps insertion
    order), with the same paths."""
    if isinstance(tree, dict):
        return [(f"{k}.{p}" if p else str(k), leaf) for k in sorted(tree)
                for p, leaf in flatten_with_paths(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}.{p}" if p else str(i), leaf)
                for i, t in enumerate(tree)
                for p, leaf in flatten_with_paths(t)]
    return [("", tree)]


INIT_PIECE = 1 << 26  # elements of one f32 draw (256 MB)


def _init_one(p: P, gen: torch.Generator, dtype, device) -> torch.Tensor:
    dtype = p.dtype or dtype
    if callable(p.init):
        return p.init(gen, p.shape, dtype, device)
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
    out = torch.empty(p.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), INIT_PIECE):
        piece = flat[i:i + INIT_PIECE]
        x = torch.randn(piece.numel(), generator=gen, dtype=torch.float32,
                        device=device)
        piece.copy_(x.mul_(std))
    return out


def init_params(tree: Tree, seed: int = 0, *, dtype=torch.float32,
                device=None) -> Tree:
    """Concrete tensors for a declaration tree, drawn leaf by leaf (in
    :func:`leaves` order) from one generator seeded with ``seed`` on
    ``device``."""
    device = torch.device(device or "cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    return tree_map(lambda p: _init_one(p, gen, dtype, device), tree)


def abstract_params(tree: Tree, dtype=torch.float32) -> Tree:
    """Tensors on the ``meta`` device shaped and typed as the declarations
    (a leaf's own dtype wins): they allocate nothing, so a step over them
    can be traced and counted for a 1T-parameter model on any host."""
    return tree_map_p(lambda p: torch.empty(p.shape, dtype=p.dtype or dtype,
                                            device="meta"), tree)


def logical_axes(tree: Tree) -> Tree:
    return tree_map_p(lambda p: tuple(p.axes), tree)


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
