"""Model/run configuration dataclasses (single source of truth for archs)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_residual: bool = False     # arctic: dense FFN in parallel with MoE
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64              # mamba2 N
    head_dim: int = 64               # mamba2 P
    num_heads: int = 0               # derived if 0: d_inner // head_dim
    expand: int = 2                  # d_inner = expand * d_model
    conv_kernel: int = 4
    chunk: int = 256                 # SSD chunk length


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    chunk: int = 256
    decay_lora: int = 64             # rank of the data-dependent decay MLP


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). Frontend is a stub:
    input_specs() provides precomputed frame embeddings."""
    num_layers: int
    num_frames: int = 1500           # whisper: 30s audio -> 1500 frames


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # attention features
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0          # window size for local layers (0 = none)
    local_global_ratio: int = 0      # gemma3: N local layers per 1 global
    attn_logit_softcap: float = 0.0

    # hybrid/ssm/moe/vlm/enc-dec extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    attn_every: int = 0              # zamba2: shared attn block every N layers
    cross_attn_every: int = 0        # vlm: cross-attn layer every N layers
    num_image_tokens: int = 0        # vlm stub frontend size
    encoder: Optional[EncoderConfig] = None

    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"          # params/compute dtype

    # sharding rule overrides for this arch (merged over DEFAULT_RULES)
    mesh_rules: Optional[Dict[str, object]] = None
    # whether this arch supports the 500k-token decode shape
    supports_long_context: bool = False
    # Cross-entropy chunk layout: "flat" reshapes to [B*T] token chunks
    # (best for giant vocabs sharded over model — gemma3/arctic); then
    # "batched" keeps [B, chunk] so batch/seq sharding survives the scan
    # (best for small-vocab archs under DP/SP — measured in §Perf).
    xent_layout: str = "flat"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """Approximate parameter count N (for 6ND MODEL_FLOPS)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.head_dim_
        n = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.rwkv is not None:
            per_layer = 4 * d * d + 2 * d * self.d_ff + 3 * d * self.rwkv.decay_lora
            n += L * per_layer
            return n
        attn = (self.num_heads + 2 * self.num_kv_heads) * d * hd + self.num_heads * hd * d
        if self.ssm is not None:
            ss = self.ssm
            d_in = ss.expand * d
            nh = ss.num_heads or d_in // ss.head_dim
            mamba = d * (2 * d_in + 2 * ss.state_dim + nh) + d_in * d + d_in * ss.conv_kernel
            n += L * (mamba + 2 * d * self.d_ff)  # zamba2 blocks have MLPs
            n += attn  # one shared attention block
            return n
        if self.moe is not None:
            mo = self.moe
            ffn = mo.num_experts * 3 * d * mo.d_ff_expert + d * mo.num_experts
            if mo.dense_residual:
                ffn += 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        n += L * (attn + ffn)
        if self.cross_attn_every:
            n_cross = L // self.cross_attn_every
            n += n_cross * ((self.num_heads + 2 * self.num_kv_heads) * d * hd
                            + self.num_heads * hd * d)
        if self.encoder is not None:
            n += self.encoder.num_layers * (attn + ffn)
            n += L * attn  # decoder cross-attention
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        mo = self.moe
        total = self.param_count()
        inactive = L * (mo.num_experts - mo.top_k) * 3 * d * mo.d_ff_expert
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
