"""Config system: one dataclass family covers all assigned architectures.

A copy of the reference package's ``configs/base.py``: the port keeps its
own so that it imports nothing of the JAX package.

Every architecture is a ``ModelConfig``; shapes are ``ShapeConfig``; quantization
is ``QuantConfig``. Configs are plain frozen dataclasses so they hash, print and
serialize trivially (no framework magic).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class QuantConfig:
    """Uniform affine quantization settings (paper Eq. 1).

    ``bits`` / ``group_size`` control weight quantization; ``act_bits`` enables
    per-token dynamic activation quantization (W4A4/W4A8 style).
    ``group_size=None`` means per-(output)-channel over the full input dim.
    ``kernel_backend`` selects how QTensor matmuls execute when serving the
    packed model: "xla" (unpack + dense matmul) or "pallas" (the
    hand-written CUDA kernels on a CUDA tensor, their plain PyTorch versions
    on a CPU tensor).
    """
    bits: int = 4
    group_size: Optional[int] = 128
    symmetric: bool = False
    act_bits: Optional[int] = None          # per-token activation quant
    act_symmetric: bool = True
    gamma: float = 1.0                      # clipping range multipliers (Eq. 1)
    beta: float = 1.0
    kernel_backend: str = "xla"             # "xla" | "pallas" QTensor dispatch

    @property
    def qmax(self) -> int:
        return (1 << self.bits) - 1

    @property
    def tag(self) -> str:
        """Canonical ``W<bits>A<act_bits>[g<group>]`` tag.

        Round-trips through ``repro_torch.launch.serve.parse_quant``:
        ``parse_quant(q.tag) == q`` for any config parse_quant can produce.
        Per-channel (``group_size=None``) omits the ``g`` suffix — the old
        ``pc`` suffix produced tags the parser rejected, so BENCH/EVAL row
        keys could not be fed back into the CLI."""
        g = f"g{self.group_size}" if self.group_size else ""
        a = f"A{self.act_bits}" if self.act_bits else "A16"
        return f"W{self.bits}{a}{g}"


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


# The four assigned LM shapes (identical across archs).
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    state_size: int = 64
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256        # chunked-scan block for SSD / linear attention


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | rwkv | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every `attn_every` layers
    attn_every: int = 0
    # encdec (whisper): encoder depth (decoder = num_layers), stub frontend length
    encoder_layers: int = 0
    frontend_len: int = 0                   # fixed frontend sequence (0 = use seq)
    # vlm: number of stubbed image-patch prefix embeddings
    num_patches: int = 0
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # training substrate knobs
    remat: bool = True
    optimizer_dtype: str = "float32"        # adam m/v dtype ("bfloat16" for 405B)
    zero1: bool = True                      # shard optimizer state over data axis
    # which shapes are valid ("" = all); long_500k auto-skipped for full attention
    sub_quadratic: bool = False             # True => can run long_500k
    # unrolled layer loop (dry-run depth-differencing only; scan otherwise)
    unroll_layers: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hd = self.resolved_head_dim
        q = self.num_heads * hd
        kv = self.num_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d
        if self.family in ("moe",):
            e = self.moe.num_experts
            ffn = 3 * d * f * e + d * e          # experts + router
        elif self.family == "rwkv":
            # time-mix (r,k,v,o,gate) + channel-mix (2 mats) approx
            attn = 0
            ffn = 5 * d * d + 2 * d * self.d_ff
        elif self.family in ("ssm",):
            attn = 0
            ffn = 0
        else:
            ffn = 3 * d * f
        if self.family == "hybrid":
            di = d * self.ssm.expand
            mamba = d * (2 * di + 2 * di) + di * d      # in_proj(x,z,b,c-ish) + out
            n_attn = 1  # shared block params counted once
            blocks = L * mamba + n_attn * (attn + 3 * d * f)
        elif self.family == "ssm" and self.ssm:  # pure mamba (unused)
            di = d * self.ssm.expand
            blocks = L * (d * 4 * di + di * d)
        else:
            blocks = L * (attn + ffn)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "encdec":
            blocks += self.encoder_layers * (2 * (d * q + 2 * d * kv + q * d) // 2 + 3 * d * f)
        return blocks + emb

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hd = self.resolved_head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        ffn = 3 * d * f * self.moe.top_k + d * self.moe.num_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn) + emb

    def shape_valid(self, shape: ShapeConfig) -> Tuple[bool, str]:
        """Whether a dry-run cell applies, with reason when it doesn't."""
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False, "skip(attn): full attention is quadratic at 500k"
        return True, ""

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
