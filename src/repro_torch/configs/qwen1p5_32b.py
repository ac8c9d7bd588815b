"""Qwen1.5-32B — dense decoder with QKV bias.

[dense] 64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064
[hf:Qwen/Qwen1.5-0.5B; hf]
"""

from repro_torch.config import ArchConfig, LoRAConfig, ModelConfig, SplitConfig


def config() -> ArchConfig:
    model = ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        activation="swiglu",
        norm="rmsnorm",
        use_rope=True,
        rope_theta=1_000_000.0,
    )
    return ArchConfig(
        model=model,
        lora=LoRAConfig(r_others=16, r_cut=8),
        split=SplitConfig(cut_layer=6, cut_buckets=(2, 6, 12, 20, 28),
                          smashed_compress="int8"),
        source="hf:Qwen/Qwen1.5-0.5B; hf",
    )
