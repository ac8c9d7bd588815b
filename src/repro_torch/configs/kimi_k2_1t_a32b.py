"""Kimi-K2 1T (32B active) — trillion-parameter MoE, 384 experts top-8.

[moe] 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384e top-8
[arXiv:2501.kimi2; unverified]

LoRA is applied to attention projections only (lora_on_experts=False):
per-expert adapters would multiply the FedAvg payload by 384, defeating the
paper's C2 rank-reduction objective — see DESIGN.md §6.
"""

from repro_torch.config import ArchConfig, LoRAConfig, ModelConfig, SplitConfig


def config() -> ArchConfig:
    model = ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=2048,           # per-expert FF dim (assigned)
        moe_d_ff=2048,
        vocab_size=163840,
        num_experts=384,
        moe_top_k=8,
        num_shared_experts=1,
        activation="swiglu",
        norm="rmsnorm",
        use_rope=True,
        router_aux_loss=0.001,
    )
    return ArchConfig(
        model=model,
        lora=LoRAConfig(r_others=16, r_cut=8, lora_on_experts=False),
        split=SplitConfig(cut_layer=6, cut_buckets=(3, 6, 12, 20),
                          smashed_compress="int8"),
        source="arXiv:2501.kimi2; unverified",
    )
