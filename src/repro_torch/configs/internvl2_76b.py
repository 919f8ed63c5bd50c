"""internvl2-76b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

Assignment specifies the LM BACKBONE; the ViT frontend is a stub —
``input_specs()`` provides (batch, n_patches, d_model) precomputed patch
embeddings that are prepended to the token sequence.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="internvl2_76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        n_patches=256,
        remat="full",
    )
)
