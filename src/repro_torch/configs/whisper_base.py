"""whisper-base [audio] — enc-dec with stubbed conv frontend [arXiv:2212.04356].

The assignment specifies the transformer BACKBONE only: ``input_specs()``
provides precomputed frame embeddings of shape (batch, n_audio_frames,
d_model); the conv1d mel frontend is a stub.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper_base",
        family="encdec",
        n_layers=6,  # decoder layers
        n_encoder_layers=6,
        n_audio_frames=1500,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51865,
        rope_theta=0.0,  # whisper uses learned positions, not RoPE
        notes="GELU MLP (not SwiGLU); learned positional embeddings; "
        "8 heads < 16-way model axis → head-padded under TP (small model, "
        "data-parallel dominant).",
    )
)
