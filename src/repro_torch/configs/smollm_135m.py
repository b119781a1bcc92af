"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M]: llama-arch small.
30L d576 9H (kv=3) d_ff 1536 vocab 49152."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    d_ff=1536, vocab_size=49152, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke", family="dense",
        num_layers=3, d_model=48, num_heads=3, num_kv_heads=1,
        d_ff=128, vocab_size=256, tie_embeddings=True, remat=False,
    )
