"""Configs of the port (counterpart of ``repro/configs/base.py``): the
language-model configs with their registry, and the ScaleGANN index-build
config (the paper's own knobs, §IV–V).

Every architecture registers a :class:`ModelConfig` from its module
``repro_torch/configs/<arch>.py``; :func:`get_arch` imports it on first
use.  The numbers are the reference's, module for module.  The dry-run's
shapes (:data:`SHAPES`), its 40 (arch × shape) cells (:func:`cells`, with
the reference's skip rule) and the production mesh shapes
(:data:`SINGLE_POD`, :data:`MULTI_POD`) are the reference's, letter for
letter; :mod:`repro_torch.launch` walks them.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional

# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # layers l with l % period == offset are MoE layers (period=1 → all MoE)
    layer_period: int = 1
    layer_offset: int = 0
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2  # d_inner = expand * d_model
    dt_rank: int = 0  # 0 → ceil(d_model / 16)
    chunk: int = 256  # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (Jamba): layers l with l % attn_period == attn_offset use
    # attention, all other layers use the SSM mixer.
    attn_period: int = 0
    attn_offset: int = 0
    # Arctic-style dense FFN residual in parallel with the MoE FFN.
    dense_residual_ff: int = 0
    # enc-dec (Whisper): encoder depth + fixed frame count from the (stubbed)
    # conv frontend; decoder uses self-attn + cross-attn.
    n_encoder_layers: int = 0
    n_audio_frames: int = 0
    # vlm: number of patch embeddings prepended by the (stubbed) ViT frontend.
    n_patches: int = 0
    # substrate knobs, as the reference's.  attn_impl maps "scan" and
    # "fa2" to one differentiable path (models/attention.py says why);
    # attn_seq_shard adds the context-parallel constraints, identities on
    # one card (distributed/sharding.py)
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots
    optimizer: str = "adamw"  # adamw | adafactor
    attn_chunk: int = 1024
    attn_impl: str = "scan"
    attn_seq_shard: bool = False
    # MoE dispatch groups: tokens are cut into this many groups, each with
    # its own capacity and its own cumulative sum (1 = one global group)
    moe_dispatch_groups: int = 1
    # recurrent-mixer chunk override (RWKV/Mamba); 0 → family default
    mixer_chunk: int = 0
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return layer_idx % self.moe.layer_period == self.moe.layer_offset

    def is_attn_layer(self, layer_idx: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_period <= 0:
            return True
        return layer_idx % self.attn_period == self.attn_offset


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    # grad-accumulation microbatch (train only); 0 → global_batch (no accum)
    microbatch: int = 0

    @property
    def resolved_microbatch(self) -> int:
        return self.microbatch or self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train", microbatch=32),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill", microbatch=8),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Archs with a sub-quadratic (state-based) sequence mixer: they run long_500k.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason). Encodes the assignment's skip rules."""
    if shape.name == "long_500k" and model.family not in SUBQUADRATIC_FAMILIES:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{model.name} ({model.family}) is full-attention — skipped per "
            "assignment (see DESIGN.md §Arch-applicability)"
        )
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = [
    "phi3_medium_14b",
    "granite_3_2b",
    "tinyllama_1_1b",
    "phi3_mini_3_8b",
    "whisper_base",
    "kimi_k2_1t_a32b",
    "arctic_480b",
    "internvl2_76b",
    "jamba_v0_1_52b",
    "rwkv6_1_6b",
]

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    name = name.replace("-", "_").replace(".", "_")
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name}")
    return _REGISTRY[name]


def all_archs() -> dict[str, ModelConfig]:
    return {a: get_arch(a) for a in ARCH_IDS}


def cells():
    """All (arch, shape, runnable, reason) dry-run cells — 40 total."""
    out = []
    for arch_id in ARCH_IDS:
        model = get_arch(arch_id)
        for shape in SHAPES.values():
            ok, reason = shape_applicable(model, shape)
            out.append((arch_id, shape.name, ok, reason))
    return out


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small width/depth,
    few experts, tiny vocab — same layer plan/period structure (the
    reference's numbers)."""
    period = 1
    if cfg.attn_period > 0:
        period = cfg.attn_period
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe.layer_period)
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff=64
        )
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=8, chunk=16)
    return dataclasses.replace(
        cfg,
        n_layers=2 * period,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        moe=moe,
        ssm=ssm,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        n_audio_frames=min(cfg.n_audio_frames, 32) if cfg.n_audio_frames else 0,
        n_patches=min(cfg.n_patches, 8) if cfg.n_patches else 0,
        dense_residual_ff=64 if cfg.dense_residual_ff else 0,
        remat="none",
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


@dataclasses.dataclass(frozen=True)
class MeshShape:
    shape: tuple
    axes: tuple

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshShape((16, 16), ("data", "model"))
MULTI_POD = MeshShape((2, 16, 16), ("pod", "data", "model"))
