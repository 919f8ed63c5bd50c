"""Carry a parameter tree of the JAX package over to the port (no
counterpart in the reference).

:func:`params_from_jax` takes the reference's parameter tree with every
leaf already a numpy array (``jax.tree.map(np.asarray, params)``), shaped
by ``repro.models.model.param_spec`` — ``blocks`` (and Whisper's
``enc_blocks``) a list of one period's layers with stacked
``[n_layers // period, ...]`` leaves, beside the embeddings, Whisper's
learned positions and final encoder norm, and the VLM's projector — and
returns the port's parameters on ``device``, so that both packages compute
the same function on the same weights.  Every leaf keeps its dtype.  This
module never sees a JAX array.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.common import params as par
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import param_spec, params_module


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: the caller's arrays may be read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(cfg: ModelConfig, tree: dict, device=None, *,
                    requires_grad: bool = False) -> nn.Module:
    """The reference's parameters (numpy leaves) → the port's module on
    ``device`` (the card unless the CPU is asked), trainable with
    ``requires_grad``.  Raises when the tree's structure or any leaf's
    shape differs from the port's spec."""
    device = resolve_device(device)
    # Whisper's decoder positions are sized by the reference's max_seq_len
    n_pos = np.shape(tree["dec_pos"])[0] if "dec_pos" in tree else 0
    spec = param_spec(cfg, max_seq_len=n_pos)
    specs = dict(par.leaves_with_paths(spec))
    got = dict(par.leaves_with_paths(tree))
    if set(specs) != set(got):
        raise ValueError(f"parameter tree differs: missing "
                         f"{sorted(set(specs) - set(got))}, extra "
                         f"{sorted(set(got) - set(specs))}")
    for path, p in specs.items():
        if tuple(np.shape(got[path])) != tuple(p.shape):
            raise ValueError(f"{path}: shape {np.shape(got[path])} against "
                             f"the spec's {p.shape}")
    return params_module(cfg, par.tree_map(lambda a: _tensor(a, device), tree),
                         requires_grad=requires_grad)
