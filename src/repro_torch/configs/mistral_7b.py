"""mistral-7b — the paper's Table 11 evaluation model [arXiv:2310.06825].
32L d4096 32H (GQA kv=8) d_ff 14336 vocab 32000.  (Sliding-window attention
is not modeled, as in the reference: the paper quantizes weights only.)"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mistral-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=224, vocab_size=256, remat=False,
    )
