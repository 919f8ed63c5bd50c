"""granite-3-2b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite_3_2b",
        family="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=49155,
        tie_embeddings=True,
        notes="vocab 49155 is not divisible by the 16-way model axis; GSPMD "
        "pads the sharded embedding/logits dims.",
    )
)
