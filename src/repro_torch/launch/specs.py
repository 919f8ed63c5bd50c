"""Meta-tensor input stand-ins + sharding resolution per (arch × shape)
(counterpart of ``repro/launch/specs.py``).

The reference's ``ShapeDtypeStruct`` stand-ins become tensors on the
``meta`` device: shapes and dtypes with no storage, so the dry-run can
count a 1T-parameter training step without allocating anything.

The decode cache differs in layout.  The reference's cache leaves carry a
leading stacked-block axis (one leaf per block position, ``[n_blocks,
B, ...]``); the port's cache (``Model.init_cache_fn``, here on ``meta``)
is a list with one dict per layer, each leaf ``[B, ...]``.
:func:`cache_shardings` walks the port's layout, and each leaf's spec is
the reference's leaf spec with the block axis dropped (that axis never
shards).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models.model import Model, build_model

VIT_DIM = 3200  # InternViT-6B hidden (frontend stub boundary)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class CellSpec:
    """Everything the dry-run needs for one (arch × shape) cell."""

    model: Model
    kind: str  # train | prefill | decode
    batch_specs: dict  # name -> meta tensor (train/prefill)
    cache_specs: Any = None  # decode only
    token_specs: Any = None  # decode only: (tokens, pos)


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.family == "vlm":
        return seq_len - cfg.n_patches
    return seq_len


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, with_labels: bool
                ) -> dict:
    b = shape.global_batch
    s = _text_len(cfg, shape.seq_len)
    specs = {"tokens": _meta((b, s), torch.int32)}
    if with_labels:
        specs["labels"] = _meta((b, s), torch.int32)
    if cfg.family == "vlm":
        specs["patch_embeds"] = _meta((b, cfg.n_patches, VIT_DIM),
                                      torch.bfloat16)
    if cfg.family == "encdec":
        specs["frames"] = _meta((b, cfg.n_audio_frames, cfg.d_model),
                                torch.bfloat16)
    return specs


def make_cell(cfg: ModelConfig, shape: ShapeConfig) -> CellSpec:
    model = build_model(cfg, max_seq_len=shape.seq_len)
    if shape.kind == "train":
        return CellSpec(
            model=model, kind="train",
            batch_specs=batch_specs(cfg, shape, with_labels=True),
        )
    if shape.kind == "prefill":
        return CellSpec(
            model=model, kind="prefill",
            batch_specs=batch_specs(cfg, shape, with_labels=False),
        )
    # decode: one new token against a seq_len cache
    b = shape.global_batch
    cache = model.init_cache_fn(b, shape.seq_len, torch.bfloat16,
                                device="meta")
    return CellSpec(
        model=model, kind="decode",
        batch_specs={},
        cache_specs=cache,
        token_specs=(_meta((b,), torch.int32), _meta((), torch.int32)),
    )


# ---------------------------------------------------------------------------
# Sharding resolution for batches and caches
# ---------------------------------------------------------------------------


def batch_shardings(specs: dict, mesh, rules=None) -> dict:
    return {
        k: shd.batch_sharding(mesh, v.shape, rules) for k, v in specs.items()
    }


_CACHE_AXES = {
    # leaf name -> logical axes for [B, ...]
    "k": ("cache_batch", "cache_kv", "cache_seq", None),
    "v": ("cache_batch", "cache_kv", "cache_seq", None),
    "conv": ("cache_batch", None, "act_mlp"),
    "h": ("cache_batch", "act_mlp", None),
    "tm_x": ("cache_batch", None),
    "cm_x": ("cache_batch", None),
    "s": ("cache_batch", "cache_kv", None, None),
}


def cache_shardings(cache_specs, mesh, rules=None):
    """A tree shaped like the port's cache, each leaf's NamedSharding by
    the leaf's name (the innermost dict key on its path)."""

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, name) for v in tree]
        axes = _CACHE_AXES.get(name)
        if axes is None:
            return shd.NamedSharding(mesh, shd.PartitionSpec())
        return shd.NamedSharding(
            mesh, shd.resolve_spec(axes, tuple(tree.shape), mesh, rules))

    return walk(cache_specs, None)
