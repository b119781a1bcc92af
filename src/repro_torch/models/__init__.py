"""Model code: dense llama-family transformer and its building blocks."""
from repro_torch.models.registry import Model, get_model

__all__ = ["Model", "get_model"]
