"""LM serving (counterpart of ``repro/serve``): slot-batched prefill and
decode of a dense model, on the card through K5 and K6."""

from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

__all__ = ["Request", "ServeConfig", "ServeEngine"]
