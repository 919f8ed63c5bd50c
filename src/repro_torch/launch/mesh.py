"""Production meshes (counterpart of ``repro/launch/mesh.py``).

The reference builds the 16×16 single-pod and 2×16×16 two-pod meshes
over 256 / 512 devices.  One H100 has no counterpart of either:
:func:`make_production_mesh` returns a spec-only mesh (the axis names and
sizes, no devices), which exists for spec resolution
(:mod:`repro_torch.distributed.sharding`) and the dry-run's per-device
byte counts.  :func:`make_host_mesh` is the mesh a step really runs on:
``(1, n)`` over the CUDA devices there are, or ``(1, 1)`` over the CPU
when the caller asks for it.  Importing this module touches no device.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import MULTI_POD, SINGLE_POD
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 single pod (256 chips) or 2×16×16 two-pod (512 chips), as
    specs.

    Axis semantics: ``pod`` is the DCN-crossing outer data axis (only
    gradient/optimizer collectives traverse it); ``data`` is intra-pod
    data/FSDP; ``model`` carries tensor/expert parallelism.
    """
    m = MULTI_POD if multi_pod else SINGLE_POD
    return Mesh(tuple(m.axes), tuple(m.shape))


def make_host_mesh(device=None) -> Mesh:
    """``(1, n)`` over the CUDA devices there are (the card unless the CPU
    is asked for; raises without CUDA), ``(1, 1)`` over the CPU with
    ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = tuple(torch.device("cuda", i)
                        for i in range(torch.cuda.device_count()))
    else:
        devices = (dev,)
    return Mesh(("data", "model"), (1, len(devices)), devices)
