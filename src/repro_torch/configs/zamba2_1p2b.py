"""Zamba2-1.2B — Mamba2 backbone with shared attention blocks (hybrid).

[hybrid] 38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf]
"""

from repro_torch.config import (ArchConfig, LoRAConfig, ModelConfig,
                                SplitConfig)


def config() -> ArchConfig:
    model = ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        activation="gelu",
        norm="rmsnorm",
        use_rope=True,
        # shared attention blocks interleaved every 6th layer (zamba2 style)
        attn_layer_indices=tuple(i for i in range(38) if i % 6 == 5),
    )
    return ArchConfig(
        model=model,
        lora=LoRAConfig(r_others=16, r_cut=8,
                        targets=("q", "k", "v", "o", "ssm_in", "ssm_out")),
        split=SplitConfig(cut_layer=4, cut_buckets=(2, 4, 8, 12, 19),
                          smashed_compress="fp8"),
        source="arXiv:2411.15242; hf",
    )
