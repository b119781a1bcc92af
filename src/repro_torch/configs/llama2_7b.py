"""llama2-7b — the paper's primary evaluation model (Table 1/2, ablations).
32L d4096 32H (MHA) d_ff 11008 vocab 32000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=32000,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama2-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=176, vocab_size=256, remat=False,
    )
