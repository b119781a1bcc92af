"""llama3-405b [arXiv:2407.21783; unverified]: 126L d16384 128H (kv=8)
d_ff 53248 vocab 128256, 128k-vocab GQA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256, rope_theta=500000.0,
    optimizer_dtype="bfloat16",   # Adam m/v in bf16, as the reference keeps them
    zero1=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=192, vocab_size=512, remat=False,
    )
