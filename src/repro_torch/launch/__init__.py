"""Serving launch layer: the prefill/decode steps, the lock-step serve loop
and the continuous-batching scheduler over the dense and paged stores."""
