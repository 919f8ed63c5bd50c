"""``repro_torch`` — the ScaleGANN reproduction in PyTorch, for one NVIDIA H100.

The reference is the JAX package ``repro`` beside this one: every module
``repro_torch.<sub>.<module>`` has exactly one counterpart
``repro.<sub>.<module>``, and this package never imports ``repro`` or
``jax``.  What it covers so far is the build and query path of the
README's quickstart: k-means partitioning with selective replication,
CAGRA shard builds (exact kNN graph plus detour pruning), the edge-union
merge, and the beam search over merged or centroid-routed split
topologies at f32, bf16 and uint8 with the exact-f32 re-rank on the
``fused``, ``torch`` and ``numpy`` backends; the DiskANN baseline
(uniform replication, batched Vamana shard builds, merge) from BIGANN
``*bin`` files; and LM serving for the dense family (TinyLlama-1.1B):
prefill and slot-batched decode through the flash-attention and
flash-decode kernels.

Parity contract.  On the same inputs, ``repro_torch.search.search`` returns
the same ids and the same ``SearchStats`` (``dataclasses.asdict``) as
``repro.search.search(..., backend="jax")``; distances agree to the
reference suite's tolerance.  The uint8 L2 stage is integer-exact.  No f32
product runs in TF32.

Device rule.  The public entry points (``build_scalegann``,
``build_diskann``, ``search``, ``make_clustered``, ``Model.init``,
``ServeEngine``) run on the card when
``device`` is not given, and raise when CUDA is missing; ``device="cpu"``
runs the plain PyTorch versions of the kernels instead.  Each kernel
wrapper takes its plain version only because the tensor it was given lies
on the CPU: on a CUDA tensor it launches the hand-written CUDA kernel
(``kernels/csrc``) or raises.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
