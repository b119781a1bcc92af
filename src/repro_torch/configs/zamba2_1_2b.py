"""zamba2-1.2b [arXiv:2411.15242]: hybrid Mamba2 backbone + one SHARED attention
block applied periodically. 38L d2048, shared attn 32H kv=32, d_ff 8192,
ssm_state 64, vocab 32000."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm=SSMConfig(state_size=64, expand=2, head_dim=64),
    attn_every=6,
    sub_quadratic=True,   # Mamba state is O(1); shared-attn KV at 500k/b1 is 3.2GB
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        ssm=SSMConfig(state_size=16, expand=2, head_dim=16, chunk_size=32),
        attn_every=2, sub_quadratic=True, remat=False,
    )
