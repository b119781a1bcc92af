"""Model code: the decoder-only transformer (dense llama family and the MoE
family) and its building blocks."""
from repro_torch.models.registry import Model, get_model

__all__ = ["Model", "get_model"]
