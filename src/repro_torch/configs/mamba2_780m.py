"""Mamba2-780M — attention-free SSD (state-space duality).

[ssm] 48L d_model=1536 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]

The paper's LoRA targets "attention modules"; with no attention present we
adapt C2 to the SSD in/out projections (the analogous dense maps) — recorded
in DESIGN.md §6 as an adaptation.
"""

from repro_torch.config import (ArchConfig, LoRAConfig, ModelConfig,
                                SplitConfig)


def config() -> ArchConfig:
    model = ModelConfig(
        name="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk=256,
        use_rope=False,
        norm="rmsnorm",
        tie_embeddings=True,
    )
    return ArchConfig(
        model=model,
        lora=LoRAConfig(r_others=16, r_cut=8, targets=("ssm_in", "ssm_out")),
        split=SplitConfig(cut_layer=4, cut_buckets=(2, 4, 8, 16, 24)),
        source="arXiv:2405.21060; unverified",
    )
