"""Model code: the decoder-only families — the transformer (dense llama
family, MoE, and the gemma backbone of the VLM), RWKV6, and the Mamba2 +
shared-attention hybrid over the chunked linear-attention engine — the
whisper-style encoder-decoder, and their building blocks."""
from repro_torch.models.registry import Model, get_model

__all__ = ["Model", "get_model"]
