"""Mistral-Large-123B — dense decoder, 88 layers.

[dense] 88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
"""

from repro_torch.config import ArchConfig, LoRAConfig, ModelConfig, SplitConfig


def config() -> ArchConfig:
    model = ModelConfig(
        name="mistral-large-123b",
        family="dense",
        num_layers=88,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=32768,
        activation="swiglu",
        norm="rmsnorm",
        use_rope=True,
        rope_theta=1_000_000.0,
    )
    return ArchConfig(
        model=model,
        lora=LoRAConfig(r_others=16, r_cut=8),
        split=SplitConfig(cut_layer=8, cut_buckets=(8, 16, 24, 32),
                          smashed_compress="int8"),
        source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
    )
