"""Serving launch layer: the prefill/decode steps and the lock-step serve
loop."""
