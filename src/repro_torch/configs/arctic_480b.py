"""arctic-480b [moe] — 128 experts top-2 + dense residual [hf:Snowflake/...]."""

from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="arctic_480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        moe=MoEConfig(n_experts=128, top_k=2, d_ff=4864),
        dense_residual_ff=4864,  # Arctic's dense FFN in parallel with the MoE
        optimizer="adafactor",
        remat="full",
        notes="56 heads do not divide the 16-way model axis; GSPMD pads.",
    )
)
