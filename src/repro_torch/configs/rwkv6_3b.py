"""rwkv6-3b "Finch" [arXiv:2404.05892]: attention-free linear attention with
data-dependent decay. 32L d2560 d_ff 8960 vocab 65536."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=8960, vocab_size=65536, head_dim=64,
    ssm=SSMConfig(head_dim=64, chunk_size=256),
    sub_quadratic=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="rwkv",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        ssm=SSMConfig(head_dim=16, chunk_size=16),
        sub_quadratic=True, remat=False,
    )
