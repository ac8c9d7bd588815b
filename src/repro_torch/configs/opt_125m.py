"""OPT-125M — paper generalizability model (Fig 4b).

12L d_model=768 12H d_ff=3072 vocab=50272, ReLU, learned positions.
"""

from repro_torch.config import (ArchConfig, DataConfig, LoRAConfig,
                                ModelConfig, SplitConfig, TrainConfig)


def config() -> ArchConfig:
    model = ModelConfig(
        name="opt-125m",
        family="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=50272,
        activation="relu",
        norm="layernorm",
        use_rope=False,
        learned_pos=True,
        max_position_embeddings=2048,
        qkv_bias=True,
        mlp_bias=True,
        tie_embeddings=True,
    )
    return ArchConfig(
        model=model,
        lora=LoRAConfig(r_others=16, r_cut=8),
        split=SplitConfig(cut_layer=2, cut_buckets=(2, 4, 6, 8, 10)),
        train=TrainConfig(batch_size=4, seq_len=512),
        data=DataConfig(num_clients=5),
        source="paper generalizability model (OPT-125M)",
    )
