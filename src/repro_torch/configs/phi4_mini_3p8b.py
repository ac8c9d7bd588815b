"""Phi-4-mini-3.8B — dense decoder, RoPE + SwiGLU + GQA.

[dense] 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064
[arXiv:2412.08905; hf]
"""

from repro_torch.config import ArchConfig, LoRAConfig, ModelConfig, SplitConfig


def config() -> ArchConfig:
    model = ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=200064,
        activation="swiglu",
        norm="rmsnorm",
        use_rope=True,
        tie_embeddings=True,
    )
    return ArchConfig(
        model=model,
        lora=LoRAConfig(r_others=16, r_cut=8),
        split=SplitConfig(cut_layer=4, cut_buckets=(2, 4, 8, 12, 16),
                          smashed_compress="fp8"),
        source="arXiv:2412.08905; hf",
    )
