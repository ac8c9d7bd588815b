"""Llama-4-Maverick 400B (17B active) — MoE top-1 routing, early fusion.

[moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""

from repro_torch.config import ArchConfig, LoRAConfig, ModelConfig, SplitConfig


def config() -> ArchConfig:
    model = ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=8192,
        moe_d_ff=8192,
        vocab_size=202048,
        num_experts=128,
        moe_top_k=1,
        num_shared_experts=1,
        activation="swiglu",
        norm="rmsnorm",
        use_rope=True,
        rope_theta=500_000.0,
        router_aux_loss=0.001,
    )
    return ArchConfig(
        model=model,
        lora=LoRAConfig(r_others=16, r_cut=8, lora_on_experts=False),
        split=SplitConfig(cut_layer=4, cut_buckets=(2, 4, 8, 16),
                          smashed_compress="int8"),
        source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    )
