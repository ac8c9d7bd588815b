"""GPT2-small — the paper's primary experimental model (12 GPT2Blocks).

12L d_model=768 12H d_ff=3072 vocab=50257, learned positions, GELU.
Paper setting: cut_layer=2 (first 2 blocks on clients, 10 on server),
r_cut=8, r_others=16, batch 4, seq 512, lr 5e-5, 5 clients.
"""

from repro_torch.config import (ArchConfig, DataConfig, LoRAConfig,
                                ModelConfig, SplitConfig, TrainConfig)


def config() -> ArchConfig:
    model = ModelConfig(
        name="gpt2-small",
        family="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=50257,
        activation="gelu",
        norm="layernorm",
        use_rope=False,
        learned_pos=True,
        max_position_embeddings=1024,
        qkv_bias=True,
        mlp_bias=True,
        tie_embeddings=True,
    )
    return ArchConfig(
        model=model,
        lora=LoRAConfig(r_others=16, r_cut=8, targets=("q", "k", "v", "o")),
        split=SplitConfig(cut_layer=2, cut_buckets=(2, 4, 6, 8, 10)),
        train=TrainConfig(batch_size=4, seq_len=512, lr_client=5e-5,
                          lr_server=5e-5),
        data=DataConfig(num_clients=5, samples_per_client=12000),
        source="paper primary model (GPT2-small)",
    )
