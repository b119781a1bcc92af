"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) [hf:moonshotai/Moonlight-16B-A3B].
48L d2048 16H (kv=16) d_ff=1408/expert, 64 experts top-6, vocab 163840."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840, head_dim=128,
    moe=MoEConfig(num_experts=64, top_k=6),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        moe=MoEConfig(num_experts=4, top_k=2),
        remat=False,
    )
