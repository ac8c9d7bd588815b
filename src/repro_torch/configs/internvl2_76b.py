"""InternVL2-76B — InternViT frontend (stub) + InternLM2 decoder backbone.

[vlm] 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[arXiv:2404.16821; unverified]
"""

from repro_torch.config import ArchConfig, LoRAConfig, ModelConfig, SplitConfig


def config() -> ArchConfig:
    model = ModelConfig(
        name="internvl2-76b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        activation="swiglu",
        norm="rmsnorm",
        use_rope=True,
        rope_theta=1_000_000.0,
        # ViT frontend stub: 256 visual tokens of precomputed patch embeddings
        frontend_prefix_len=256,
        frontend_dim=8192,
    )
    return ArchConfig(
        model=model,
        lora=LoRAConfig(r_others=16, r_cut=8, targets=("q", "k", "v", "o")),
        split=SplitConfig(cut_layer=8, cut_buckets=(4, 8, 16, 24, 32),
                          smashed_compress="int8"),
        source="arXiv:2404.16821; unverified",
    )
