"""``repro_torch.serve`` — the **LM decode** serving engine (counterpart of
``repro/serve``): slot-batched prefill and decode of the dense, MoE, hybrid
and RWKV families, on the card through K5 and K6, and ANN-retrieval
attention over a KV cache's keys (:mod:`.retrieval_attention`).

Not the ANN query server: ANN query serving lives in
``repro_torch.serving`` (:class:`repro_torch.serving.AnnServer`)."""

from repro_torch.serve.engine import (Request, ServeConfig, ServeEngine,
                                     serve_step_fn)
from repro_torch.serve.retrieval_attention import (KeyIndex, build_key_indexes,
                                                   full_decode_attention_ref,
                                                   retrieval_decode_attention)

__all__ = ["KeyIndex", "Request", "ServeConfig", "ServeEngine",
           "build_key_indexes", "full_decode_attention_ref",
           "retrieval_decode_attention", "serve_step_fn"]
