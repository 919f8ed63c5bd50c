"""Language models of the port (counterpart of ``repro/models``): every
family's forward, prefill and decode (dense, MoE, hybrid Mamba, RWKV6,
Whisper encoder-decoder, VLM), on the card through K5 and K6."""
