"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]. 48L d2048 32H (kv=4) d_ff=768/expert,
128 experts top-8, vocab 151936."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=8),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256, head_dim=16,
        moe=MoEConfig(num_experts=8, top_k=2),
        remat=False,
    )
