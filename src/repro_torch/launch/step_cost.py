"""The cost of one step, counted from the torch program itself
(counterpart of ``repro/launch/hlo_cost.py``).

The reference parses the optimized HLO text of a compiled step and
multiplies each ``while`` body by its trip count.  The port has no HLO: it
runs the step eagerly, so :func:`analyze` runs ``fn`` once on ``meta``
tensors (shapes and dtypes, no storage, nothing computed) under one
``TorchDispatchMode`` and counts every aten op the step dispatches.  A
Python loop (microbatches, layers, attention chunks) is counted as many
times as it runs, which is what the reference's trip-count multiplication
reconstructs.

  * FLOPs — the matrix products, by torch's own formulas
    (``torch.utils.flop_counter.flop_registry``: mm, addmm, bmm, baddbmm,
    convolutions; ``einsum`` and ``@`` reach these); elementwise ops count
    nothing, where the reference counts one flop an element.
  * Bytes — for each op that materializes an output (not a view), the
    bytes of its tensor inputs and of its output: the traffic of the eager
    program, every intermediate written to and read back from memory.  The
    reference's count is fusion-aware (a fused intermediate never reaches
    HBM), so this one is higher for the same program; neither is the least
    a step must move.  An in-place op does not count its destination as an
    input.
  * Attention is counted by the work it needs.  The kernels' wrappers
    (``ops.flash_attention``, ``flash_attention_lse``, ``flash_decode``)
    and the FA2 backward (``flash_vjp.flash_attention_bwd``) take no
    plain path on ``meta`` tensors: they report their work to
    ``ops.WORK_LISTENERS`` and return empty outputs.  Causal attention
    counts the lower triangle with its diagonal (query ``i`` sees ``min(T, i + T - S + 1)`` keys), 4·Dh flops
    a (head, query, key) pair forward (QKᵀ and PV) and 10·Dh backward (the
    FA2 recompute of P, dV, dP, dQ, dK); decode counts ``lens`` keys a row
    (every key of the cache when ``lens`` is itself on ``meta`` and has no
    values); bytes are the operands read once and the outputs written
    once.  The plain path's S×T product would count causal attention
    twice.
  * Collectives — ``collective_bytes`` is ``{}`` and ``n_collectives`` 0:
    the port runs on one card, and :mod:`repro_torch.distributed.sharding`
    lowers no collective (its constraints are identities), so there is
    nothing to count.  A multi-card port would count them where it issues
    them.

The ops run on ``meta``, where torch computes each output's shape (in
Python for pointwise ops).  The counter keeps each op's count and output
shapes by its arguments' shapes, strides and dtypes, for every count in
the process, and answers a repeat from there (an in-place op on ``meta``
changes nothing and is not run again), so a step's 40 layers cost one
layer's shape computation and a table lookup for the rest; every op is
still counted.

The counts are global (the whole step), not per device: the reference's
per-device count is its global count over the devices only when nothing
is replicated.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.common import params as par
from repro_torch.kernels import ops

_aten = torch.ops.aten
# ops that write nothing (allocation only) or only describe tensors
_NO_TRAFFIC = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.detach, _aten.lift_fresh, _aten.alias,
    _aten._unsafe_view,
    _aten._local_scalar_dense, _aten.sym_size, _aten.sym_stride,
    _aten.sym_numel, _aten.sym_storage_offset,
}


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in par.leaves(tree)
               if isinstance(t, torch.Tensor))


def _signature(args) -> tuple:
    """A key of an op's arguments: each tensor by its shape, strides and
    dtype (what a meta output's shape and a count depend on), lists and
    tuples element by element, anything else as it is (the key is
    unhashable, and nothing is kept, when such an argument is)."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append((a.shape, a.stride(), a.dtype))
        elif isinstance(a, (list, tuple)):
            out.append(_signature(a))
        else:
            out.append(a)
    return tuple(out)


def _fresh(x):
    """New meta tensors with the metadata of ``x`` (tensors in nested
    tuples and lists)."""
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    if isinstance(x, (list, tuple)):
        return type(x)(_fresh(v) for v in x)
    return x


# (flops, bytes, output metadata) by (op, arguments' metadata), shared by
# every count in the process: torch's meta kernels of pointwise ops run in
# Python (~0.1 ms a call), and steps repeat the same ops layer after layer
_SEEN: dict = {}
_FRESH, _IN_PLACE, _RUN = range(3)
_RESIZING = {"resize_", "resize_as_", "set_", "as_strided_"}


@functools.cache
def _kind(func) -> int:
    """``_FRESH``: the op writes nothing and returns only new tensors, so
    its meta outputs depend on its arguments' metadata alone;
    ``_IN_PLACE``: it writes its first argument and returns it (shape and
    strides unchanged); ``_RUN``: anything else (views, ``out=`` forms,
    resizes), which is always run."""
    schema = func._schema
    rets = schema.returns
    if not rets:
        return _RUN
    if not schema.is_mutable:
        fresh = all(r.alias_info is None and "Tensor" in str(r.type)
                    for r in rets)
        return _FRESH if fresh else _RUN
    first = schema.arguments[0].alias_info if schema.arguments else None
    ret = rets[0].alias_info
    if (len(rets) == 1 and first is not None and ret is not None
            and first.is_write and ret.before_set == first.before_set
            and func._overloadpacket.__name__ not in _RESIZING):
        return _IN_PLACE
    return _RUN


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: dict[str, dict] = {}

    def _cost(self, func, args, kwargs, out) -> tuple[int, int]:
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        flops = (int(formula(*args, **kwargs, out_val=out))
                 if formula is not None else 0)
        nbytes = 0
        if not func.is_view and packet not in _NO_TRAFFIC:
            ins = args[1:] if func._schema.is_mutable else args
            nbytes = (_tensor_bytes(ins) + _tensor_bytes(kwargs)
                      + _tensor_bytes(out))
        return flops, nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = (func, _signature(args),
               _signature(kwargs.values()) if kwargs else None,
               tuple(kwargs) if kwargs else None)
        try:
            hit = _SEEN.get(key)
        except TypeError:  # an argument with no hashable metadata
            key = hit = None
        kind = _kind(func)
        if hit is not None and kind == _FRESH:
            out = _fresh(hit[2])
        elif hit is not None and kind == _IN_PLACE:
            out = args[0]
        else:
            out = func(*args, **kwargs)
        if hit is None:
            hit = (*self._cost(func, args, kwargs, out),
                   _fresh(out) if kind == _FRESH else None)
            if key is not None:
                _SEEN[key] = hit
        self.flops += hit[0]
        self.bytes += hit[1]
        return out

    def kernel_work(self, name: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes


def _to_meta(tree):
    return par.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta",
                              requires_grad=t.requires_grad)
        if isinstance(t, torch.Tensor) else t, tree)


def analyze(fn, *args) -> dict:
    """Run ``fn(*args)`` once and count it.  Tensors among ``args`` (also
    inside dicts, lists and tuples) are replaced by ``meta`` tensors of the
    same shape, dtype and ``requires_grad``; other arguments (a model's
    parameter module, already on ``meta``) pass as they are.

    Returns ``{"flops", "bytes", "collective_bytes": {}, "n_collectives":
    0, "kernels": {name: {"calls", "flops", "bytes"}}}``, the last being
    the attention kernels' registered counts (already in the totals)."""
    counter = _Counter()
    ops.WORK_LISTENERS.append(counter.kernel_work)
    try:
        with counter:
            fn(*_to_meta(args))
    finally:
        ops.WORK_LISTENERS.remove(counter.kernel_work)
    return {"flops": counter.flops, "bytes": counter.bytes,
            "collective_bytes": {}, "n_collectives": 0,
            "kernels": counter.kernels}
