"""phi3-mini-3.8b [dense] — RoPE SwiGLU, MHA (kv=32) [arXiv:2404.14219]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="phi3_mini_3_8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
    )
)
