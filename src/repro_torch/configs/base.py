"""Configs of the port (counterpart of ``repro/configs/base.py``): the
language-model configs with their registry, and the ScaleGANN index-build
config (the paper's own knobs, §IV–V).

Every architecture registers a :class:`ModelConfig` from its module
``repro_torch/configs/<arch>.py``; :func:`get_arch` imports it on first
use.  The numbers are the reference's, module for module.
"""

from __future__ import annotations

import dataclasses
import importlib
import math

# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The dense fields of the reference's ``ModelConfig``: the ones this
    port reads.  A family's own fields (MoE, SSM, encoder, patches) come
    with the slice that ports it."""

    name: str
    family: str  # dense (other families raise in models/model.py)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    name = name.replace("-", "_").replace(".", "_")
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name}")
    return _REGISTRY[name]


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small width and
    depth, tiny vocab (the reference's numbers for a dense model)."""
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )


# ---------------------------------------------------------------------------
# ScaleGANN index-build config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Paper knobs. Defaults follow §VI (R=64, L=128, ε=1.2, ω=2)."""

    n_clusters: int = 16
    degree: int = 64  # R — final graph degree
    build_degree: int = 128  # L — intermediate kNN-graph degree
    epsilon: float = 1.2  # ε — selective-replication pruning strength
    omega: int = 2  # ω — max clusters a vector may appear in
    tau0: float = 2.0  # τ schedule: tau0 → 1.0 as blocks are processed
    theta: float = 0.35  # base replica-space fraction per cluster
    block_size: int = 8192  # disk-block size (vectors per block)
    kmeans_iters: int = 12
    kmeans_sample: int = 65536  # centroids trained on a sample (DiskANN-style)
    capacity_slack: float = 1.25  # cluster capacity = slack * N / k
    nn_descent_iters: int = 8
    metric: str = "l2"  # l2 | ip
    seed: int = 0

    def tau(self, block_idx: int, n_blocks: int) -> float:
        """Dynamic radius correction: large early, →1.0 by the last block."""
        if not math.isfinite(self.tau0):  # selective=False: pruning disabled
            return self.tau0
        if n_blocks <= 1:
            return 1.0
        frac = block_idx / (n_blocks - 1)
        return float(self.tau0 + (1.0 - self.tau0) * frac)
