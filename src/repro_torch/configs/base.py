"""Model/config schema shared by all assigned architectures.

A copy of ``repro/configs/base.py`` so that the port needs nothing of the
JAX package.  A model is a *program* of layer segments.  Each segment is a
unit of one or more ``LayerSpec``s repeated R times.  The JAX package scans
units with R > 1 over stacked parameters; the port runs every layer in a
Python loop over per-layer parameters (``models/convert.py`` unstacks JAX
pytrees).  This representation covers every assigned pattern exactly:

  qwen3-4b      [(full,) x 36]
  gemma3-4b     [(l,l,l,l,l,g) x 5, (l,l,l,l) x 1]       5:1 local:global
  gemma2-9b     [(l,g) x 21]                              alternating
  llama4        [(moe, dense) x 24]                       interleaved MoE
  deepseek-v2   [(dense-mla,) x 1, (moe-mla,) x 26]       first layer dense
  hymba         [(hg,) 1, (hl,) 15, (hg,) 1, (hl,) 14, (hg,) 1]
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal

AttnKind = Literal["full", "window", "mla", "mamba", "hybrid", "none"]
FFNKind = Literal["dense", "moe", "none"]


@dataclass(frozen=True)
class LayerSpec:
    attn: AttnKind = "full"
    ffn: FFNKind = "dense"
    window: int | None = None     # sliding-window width when attn in (window, hybrid)
    cross_attn: bool = False      # decoder layers of enc-dec models


# A program segment: (unit of layer specs, repeat count).
Segment = tuple[tuple[LayerSpec, ...], int]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | vlm | ssm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    program: tuple[Segment, ...]

    # ---- attention options ----
    qk_norm: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, int, int] | None = None  # M-RoPE (qwen2-vl)
    attn_scale: float | None = None                     # override 1/sqrt(hd)

    # ---- MLA (deepseek) ----
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- MoE ----
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_type: str = "softmax"  # softmax | sigmoid (llama4 top-1)

    # ---- FFN ----
    ffn_act: str = "swiglu"       # swiglu | gelu

    # ---- SSM (mamba2 / hymba) ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 64
    ssm_groups: int = 1
    conv_kernel: int = 4

    # ---- enc-dec (whisper) ----
    is_encoder_decoder: bool = False
    enc_program: tuple[Segment, ...] = ()
    enc_seq: int = 0              # encoder frames (post-frontend stub)

    # ---- frontends (stubs: input_specs() provides the embeddings) ----
    frontend: str | None = None   # vision_stub | audio_stub
    num_patch_tokens: int = 0     # vlm: patch embeddings prepended to the text

    # ---- misc ----
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    norm_type: str = "rms"        # rms | layer (whisper)
    scale_embed: bool = False     # gemma-style sqrt(d_model) embedding scale
    dtype: str = "bfloat16"
    # post-attn/post-ffn extra norms (gemma2/gemma3 style sandwich norms)
    sandwich_norms: bool = False

    def __post_init__(self):
        n = sum(len(unit) * reps for unit, reps in self.program)
        if n != self.num_layers:
            raise ValueError(
                f"{self.name}: program covers {n} layers, config says {self.num_layers}"
            )

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-scale sibling of the same family (see configs/<arch>.py)."""
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def uniform_program(spec: LayerSpec, n: int) -> tuple[Segment, ...]:
    return ((tuple([spec]), n),)
