"""Optimizers of the port (AdamW, hand-ported from the reference)."""
