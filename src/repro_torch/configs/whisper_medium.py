"""Whisper-medium — encoder-decoder with conv audio frontend (stub).

[audio] 24L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=51865
[arXiv:2212.04356; unverified]

The conv frontend is a STUB: input_specs() supplies precomputed 1500-frame
mel-embeddings (30 s at 50 Hz post-conv).  The paper's client/server split
maps onto an encoder-side cut: a cut inside the 24 encoder layers.
"""

from repro_torch.config import ArchConfig, LoRAConfig, ModelConfig, SplitConfig


def config() -> ArchConfig:
    model = ModelConfig(
        name="whisper-medium",
        family="audio",
        num_layers=24,            # decoder layers
        num_encoder_layers=24,
        encoder_seq_len=1500,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        activation="gelu",
        norm="layernorm",
        use_rope=False,
        learned_pos=True,
        max_position_embeddings=4096,
        frontend_prefix_len=1500,
        frontend_dim=1024,
        mlp_bias=True,
    )
    return ArchConfig(
        model=model,
        lora=LoRAConfig(r_others=16, r_cut=8, targets=("q", "k", "v", "o")),
        split=SplitConfig(cut_layer=4, cut_buckets=(2, 4, 8, 12)),
        source="arXiv:2212.04356; unverified",
    )
