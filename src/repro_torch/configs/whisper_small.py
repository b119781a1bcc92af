"""whisper-small [arXiv:2212.04356; unverified]: enc-dec, conv frontend STUB
(input_specs provides precomputed frame embeddings). 12L enc + 12L dec,
d768 12H (kv=12) d_ff 3072 vocab 51865."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    encoder_layers=12, frontend_len=1500,   # standard whisper 30s => 1500 frames
    rope_theta=0.0,                          # whisper uses learned/sinusoidal pos
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        encoder_layers=2, frontend_len=32, rope_theta=0.0, remat=False,
    )
