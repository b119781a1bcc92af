"""tinyllama-1.1b [arXiv:2401.02385]: llama2-arch small.
22L d2048 32H (kv=4) d_ff 5632 vocab 32000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=5632, vocab_size=32000,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=160, vocab_size=256, remat=False,
    )
