"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219; unverified]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="phi3_medium_14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        vocab_size=100352,
        remat="full",
        notes="40 q-heads / 10 kv-heads do not divide the 16-way model axis; "
        "GSPMD pads — see EXPERIMENTS.md §Perf (hillclimb target).",
    )
)
