"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

Jamba block structure: within each 8-layer block, layer index 4 is attention
(1:7 attn:mamba ratio); every second layer (odd) uses the 16-expert MoE MLP.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="jamba_v0_1_52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        moe=MoEConfig(
            n_experts=16, top_k=2, d_ff=14336, layer_period=2, layer_offset=1
        ),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        attn_period=8,
        attn_offset=4,
        remat="full",
    )
)
