"""Public kernel surface of the port.

The six hand-written CUDA kernels (``csrc/``) sit behind these functions:
``pairwise_distance`` (K1), ``pairwise_distance_u8`` (K2), ``knn`` (K4),
``fused_beam`` (K3), ``flash_attention`` (K5) and ``flash_decode`` (K6).
Each takes its plain PyTorch version for a CPU tensor and launches its
kernel for a CUDA tensor.  ``LAUNCHES`` counts the launches per kernel;
``reset_counts`` zeroes it; ``build_all`` compiles every kernel up front.
"""

from repro_torch.kernels._build import LAUNCHES, build_all, reset_counts
from repro_torch.kernels.beam import default_n_iters, fused_beam
from repro_torch.kernels.ops import (flash_attention, flash_decode, knn,
                                     pairwise_distance, pairwise_distance_u8,
                                     rerank_exact)

__all__ = [
    "LAUNCHES", "build_all", "default_n_iters", "flash_attention",
    "flash_decode", "fused_beam", "knn", "pairwise_distance",
    "pairwise_distance_u8", "reset_counts", "rerank_exact",
]
