"""paligemma-3b [arXiv:2407.07726]: SigLIP vision tower STUB (input_specs
provides patch embeddings) + gemma text backbone. 18L d2048 8H (kv=1, MQA)
d_ff 16384 vocab 257216."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    d_ff=16384, vocab_size=257216, head_dim=256,
    num_patches=256,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="paligemma-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=256, head_dim=16,
        num_patches=8, remat=False,
    )
