"""Llama-3-8B — dense decoder, GQA, 128k vocab.

[dense] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[arXiv:2407.21783; unverified]
"""

from repro_torch.config import ArchConfig, LoRAConfig, ModelConfig, SplitConfig


def config() -> ArchConfig:
    model = ModelConfig(
        name="llama3-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        activation="swiglu",
        norm="rmsnorm",
        use_rope=True,
        rope_theta=500_000.0,
    )
    return ArchConfig(
        model=model,
        lora=LoRAConfig(r_others=16, r_cut=8),
        split=SplitConfig(cut_layer=4, cut_buckets=(2, 4, 8, 12, 16),
                          smashed_compress="int8"),
        source="arXiv:2407.21783; unverified",
    )
