"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2].

AdamW state for ~1T params (12 TB) exceeds 256×16 GB HBM; this config uses
Adafactor + full FSDP + full remat (recorded in EXPERIMENTS.md §Dry-run).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="kimi_k2_1t_a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=2048,  # per-expert hidden dim (dense path unused)
        vocab_size=163840,
        moe=MoEConfig(
            n_experts=384,
            top_k=8,
            d_ff=2048,
            n_shared_experts=1,
            capacity_factor=1.25,
        ),
        optimizer="adafactor",
        remat="full",
    )
)
