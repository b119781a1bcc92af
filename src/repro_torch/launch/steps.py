"""The prefill/decode steps for single-device serving."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.models.common import make_ctx


def make_serve_steps(cfg: ModelConfig, *, attn_chunk: int = 512,
                     kernel_backend=None):
    """Returns (model, prefill_step, decode_step).

    ``kernel_backend`` ("xla" | "pallas" | None = env/default) selects the
    QTensor matmul and decode-attention path for both steps; ``attn_chunk``
    is the prefill attention's KV chunk.  Meshes, tensor parallelism and
    the paged store are not ported yet (ROADMAP queue 1)."""
    model = get_model(cfg)
    ctx = make_ctx(attn_chunk=attn_chunk, kernel_backend=kernel_backend)

    def prefill_step(params, batch, cache, start_pos=0):
        return model.prefill(params, batch, cache, ctx, start_pos=start_pos)

    def decode_step(params, cache, tokens, pos, active=None):
        return model.decode_step(params, cache, tokens, pos, ctx,
                                 active=active)

    return model, prefill_step, decode_step
