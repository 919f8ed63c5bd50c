"""Logical-axis sharding rules (counterpart of
``repro/distributed/sharding.py``): the reference's rules, resolution and
summaries over axis names and sizes, with no JAX.

Every parameter / activation dim carries a *logical* axis name (declared
in the ``P`` specs and the activation constraints); :func:`resolve_spec`
maps them onto mesh axes with the reference's **divisibility-checked**
resolution: a rule's mesh axes are applied left to right, skipping axes an
earlier dim of the same tensor consumed and stopping at the first axis
that does not divide the dim.

Default placement (the reference's):
  * tensor-parallel (``model`` axis): mlp / heads / kv / vocab / experts
  * FSDP (``pod`` + ``data``): embed dims of all weight matrices (ZeRO-3)
  * batch dims: (``pod``, ``data``)
  * decode KV caches: batch → data, kv-heads → model when divisible, else
    cache_seq → model (sequence-sharded attention for the 500k cells)

What one card cannot give: the port runs on one H100, so a mesh here is a
*spec* (axis names and sizes, :class:`Mesh`), and a resolved
:class:`NamedSharding` says how the production meshes would split a tensor
(the dry-run's per-device bytes) without splitting anything.  There is no
``torch.distributed`` and no DTensor: one card has no collectives to
lower.  :func:`constrain` resolves its spec against the tensor's shape
under :func:`use_mesh_rules` (so a rank mismatch raises, as the
reference's constraint would) and returns the tensor itself, since one
card holds every shard.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional

import torch

from repro_torch.common import params as par
from repro_torch.common.params import P

# logical axis -> tuple of candidate mesh axes (applied in order)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # --- parameters ---
    "embed": ("pod", "data"),  # ZeRO-3 / FSDP
    "embed2": (),  # second embed dim of square weights: replicated
    "mlp": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    par.LAYER_AXIS: (),  # stacked layers never shard
    # --- activations ---
    "batch": ("pod", "data"),
    "seq": (),  # flipped to ("model",) by sequence-parallel rules
    "seq_attn": ("model",),  # context-parallel attention (opt-in constrain)
    "act_embed": (),
    "act_mlp": ("model",),
    "act_heads": ("model",),
    "act_kv": ("model",),
    "act_vocab": ("model",),
    "act_experts": ("model",),
    "capacity": (),
    "dispatch": ("pod", "data"),  # MoE dispatch groups (local capacity)
    # --- serving caches ---
    "cache_batch": ("pod", "data"),
    "cache_kv": ("model",),
    "cache_seq": ("data", "model"),  # consumes whatever batch/kv left free
}


def seq_parallel_rules(rules: dict | None = None) -> dict:
    """Sequence-parallel variant: long-context activations shard over model."""
    r = dict(rules or DEFAULT_RULES)
    r["seq"] = ("model",)
    r["act_embed"] = ()
    return r


class PartitionSpec(tuple):
    """One entry per dim: ``None``, a mesh axis, or a tuple of mesh axes;
    trailing ``None`` entries are trimmed.  Spelled as the reference's
    (``PartitionSpec(('pod', 'data'), 'model')``)."""

    def __new__(cls, *parts):
        parts = list(parts)
        while parts and parts[-1] is None:
            parts.pop()
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh as one card sees it: axis names and sizes, and the
    devices it holds (row-major; ``None`` for a spec-only mesh such as the
    production ones, which exist here for spec resolution only)."""

    axis_names: tuple
    axis_sizes: tuple
    devices: Optional[tuple] = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec

    def shard_factor(self) -> int:
        """Into how many pieces the spec splits a tensor."""
        sizes = self.mesh.shape
        return math.prod(sizes[a] for part in self.spec if part is not None
                         for a in (part if isinstance(part, tuple)
                                   else (part,)))


def resolve_spec(axes: tuple, shape: tuple, mesh: Mesh,
                 rules: dict | None = None) -> PartitionSpec:
    """Logical axes + concrete shape → PartitionSpec (divisibility-checked)."""
    rules = rules or DEFAULT_RULES
    axis_sizes = mesh.shape
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, axes):
        if name is None:
            out.append(None)
            continue
        cand = [a for a in rules.get(name, ())
                if a in axis_sizes and a not in used]
        picked: list[str] = []
        prod = 1
        for a in cand:
            if dim % (prod * axis_sizes[a]) == 0:
                picked.append(a)
                prod *= axis_sizes[a]
            else:
                break
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return PartitionSpec(*out)


def param_shardings(spec_tree, mesh: Mesh, rules: dict | None = None):
    """P-declaration tree (a ``TrainState`` of them too) → NamedSharding
    tree."""

    def one(p: P):
        return NamedSharding(mesh, resolve_spec(p.axes, p.shape, mesh, rules))

    return par.tree_map_p(one, spec_tree)


# ---------------------------------------------------------------------------
# Activation constraints (no-op outside a mesh context)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Ctx:
    mesh: Optional[Mesh] = None
    rules: Optional[dict] = None


_CTX = threading.local()


def _ctx() -> _Ctx:
    if not hasattr(_CTX, "v"):
        _CTX.v = _Ctx()
    return _CTX.v


@contextlib.contextmanager
def use_mesh_rules(mesh: Mesh, rules: dict | None = None):
    """Activate activation-sharding constraints (model code stays mesh-
    agnostic; with no context the constraints are no-ops)."""
    prev = _ctx().mesh, _ctx().rules
    _ctx().mesh, _ctx().rules = mesh, rules or DEFAULT_RULES
    try:
        yield
    finally:
        _ctx().mesh, _ctx().rules = prev


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes (``x``
    a tensor or an array): ``x`` itself with no context; under :func:`use_mesh_rules` the spec is
    resolved against ``x.shape`` (a rank mismatch raises) and ``x`` is
    returned unchanged, one card holding every shard."""
    c = _ctx()
    if c.mesh is None:
        return x
    if len(axes) != len(x.shape):
        raise ValueError(f"constraint axes {axes} do not match shape "
                         f"{tuple(x.shape)}")
    resolve_spec(tuple(axes), tuple(x.shape), c.mesh, c.rules)
    return x


def batch_sharding(mesh: Mesh, shape: tuple, rules: dict | None = None
                   ) -> NamedSharding:
    """Sharding for [B, ...] host batches (batch → (pod, data)),
    divisibility-checked (long_500k has global_batch=1 → replicated)."""
    axes = ("batch",) + (None,) * (len(shape) - 1)
    return NamedSharding(mesh, resolve_spec(axes, tuple(shape), mesh, rules))


def shard_info(shardings) -> dict:
    """How many leaves take each spec (keyed by the spec's spelling)."""
    specs: dict[str, int] = {}
    for s in par.leaves(shardings):
        key = str(s.spec)
        specs[key] = specs.get(key, 0) + 1
    return specs
