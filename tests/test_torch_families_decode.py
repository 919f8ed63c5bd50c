"""Every model family's ``prefill`` and 4 ``decode_step``s against the JAX
package's, on the CPU (logits at every step, every cache leaf after the
prefill and after the last step), at the tolerances and in the reference
modes that ``test_torch_families.py``'s docstring states: f32 end to end
at ``1e-4 × max|x|``, bf16 at ``2e-2 × max|x|`` against the reference
compiled with XLA's excess precision off, Jamba's bf16 layer by layer
(ROADMAP.md queue C)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_families import (DTYPES, LAYER_BY_LAYER, T, _batch, _close,
                                 _layer_by_layer, _per_layer_caches,
                                 _reference, pair)

__all__ = ["pair"]  # the shared fixture, one instance per arch here


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_reference(pair, dtype):
    jcfg, jm, jp, cfg, tm, tp = pair
    if dtype == "bf16" and cfg.name in LAYER_BY_LAYER:
        return _layer_by_layer(pair, decode=True)
    jdt, tdt = DTYPES[dtype]
    batch = _batch(cfg, seed=1)
    max_len = 48 + cfg.n_patches
    jl, jc = _reference(
        lambda p, b: jm.prefill_fn(p, b, max_len, dtype=jdt), dtype)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    decode = _reference(
        lambda p, c, t, pos: jm.decode_fn(p, c, t, pos, dtype=jdt), dtype)
    tl, tc = tm.prefill_fn(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, max_len,
        dtype=tdt)
    _close(tl, jl, dtype)

    def caches_close():
        for lc, jlc in zip(tc["layers"], _per_layer_caches(cfg, jc)):
            assert set(lc) == set(jlc)
            for name, a in lc.items():
                _close(a, jlc[name], dtype)
        for i, kv in enumerate(tc.get("cross_kv", [])):
            for name in ("k", "v"):
                _close(kv[name], jc["cross_kv"][name][i], dtype)

    caches_close()
    pos = T + cfg.n_patches
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jl[:, :cfg.vocab_size], axis=-1),
                         np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tok), jnp.int32(pos))
        tl, tc = tm.decode_fn(tp, tc, torch.from_numpy(tok), pos, dtype=tdt)
        _close(tl, jl, dtype)
        pos += 1
    caches_close()
