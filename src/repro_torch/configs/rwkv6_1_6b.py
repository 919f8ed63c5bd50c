"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attn-free [arXiv:2404.05892]."""

from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="rwkv6_1_6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,  # WKV heads (head_dim 64)
        n_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        ssm=SSMConfig(chunk=256),
        notes="attention-free: time-mix (WKV6) + channel-mix; long_500k runs "
        "with O(1) recurrent state.",
    )
)
