"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01; unverified]: dense GQA,
no-bias. 40L d8192 64H (kv=8) d_ff 22528 vocab 256000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000, rope_theta=8_000_000.0,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="command-r-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=160, vocab_size=256, remat=False,
    )
