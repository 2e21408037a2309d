"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

M-RoPE with sections (16, 24, 24) over head_dim=128; dynamic-resolution
vision frontend is a STUB per the assignment — ``input_specs()`` provides
1024 precomputed patch embeddings per sample plus explicit 3-channel (t/h/w)
positions; text tokens fill the rest of the sequence.  [arXiv:2409.12191; hf]

A copy of ``repro/configs/qwen2_vl_7b.py``: 7,615,487,488 parameters,
15,231,383,552 B in bf16 with the norm scales kept in fp32 (an untied
head).  The published model adds a bias to q, k and v; the reference's
config and layers have none, and the port computes the reference's
function, so it has none either.
"""

from .base import LayerSpec, ModelConfig, uniform_program

_SPEC = LayerSpec(attn="full", ffn="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152_064,
        program=uniform_program(_SPEC, 28),
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        frontend="vision_stub",
        num_patch_tokens=1024,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke",
        family="vlm",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        program=uniform_program(_SPEC, 3),
        mrope_sections=(2, 3, 3),
        frontend="vision_stub",
        num_patch_tokens=8,
        dtype="float32",
    )
