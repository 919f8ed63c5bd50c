"""``repro_torch.serve`` — the **LM decode** serving engine (counterpart of
``repro/serve``): slot-batched prefill and decode of the dense, MoE, hybrid
and RWKV families, on the card through K5 and K6.

Not the ANN query server: ANN query serving lives in
``repro_torch.serving`` (:class:`repro_torch.serving.AnnServer`)."""

from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

__all__ = ["Request", "ServeConfig", "ServeEngine"]
