"""Public kernel surface of the port.

The seven hand-written CUDA kernels (``csrc/``) sit behind these functions:
``pairwise_distance`` (K1), ``pairwise_distance_u8`` (K2), ``knn`` (K4),
``fused_beam`` (K3), ``flash_attention`` (K5), ``flash_decode`` (K6) and
``merge_rows`` (the shard-graph merge, which has no TPU kernel).
Each takes its plain PyTorch version for a CPU tensor and launches its
kernel for a CUDA tensor.  ``LAUNCHES`` counts the launches per kernel;
``knn_launches`` gives the shape and seconds of each ``knn`` call made
while a tracer was enabled; ``reset_counts`` zeroes both; ``build_all``
compiles every kernel up front.
"""

from repro_torch.kernels._build import (LAUNCHES, build_all, knn_launches,
                                       reset_counts)
from repro_torch.kernels.beam import default_n_iters, fused_beam
from repro_torch.kernels.merge import merge_rows
from repro_torch.kernels.ops import (flash_attention, flash_decode, knn,
                                     pairwise_distance, pairwise_distance_u8,
                                     rerank_exact)

__all__ = [
    "LAUNCHES", "build_all", "default_n_iters", "flash_attention",
    "flash_decode", "fused_beam", "knn", "knn_launches", "merge_rows",
    "pairwise_distance", "pairwise_distance_u8", "reset_counts",
    "rerank_exact",
]
