"""mamba2-370m [ssm]: 48L d_model=1024, attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; the
state-spaces/mamba2-370m checkpoint's config]

A copy of ``repro/configs/mamba2_370m.py``.

d_inner = 2*1024 = 2048, headdim 64 -> 32 SSM heads, chunk 256, conv kernel 4.
Decode cost is O(1) per token (constant [B,H,P,N] state), which is why this
arch runs the long_500k cell.
"""

from .base import LayerSpec, ModelConfig, uniform_program

_SPEC = LayerSpec(attn="mamba", ffn="none")


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50_280,
        program=uniform_program(_SPEC, 48),
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_chunk=256,
        ssm_groups=1,
        conv_kernel=4,
        tie_embeddings=True,
        norm_eps=1e-5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke",
        family="ssm",
        num_layers=3,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=512,
        program=uniform_program(_SPEC, 3),
        ssm_state=16,
        ssm_expand=2,
        ssm_headdim=16,
        ssm_chunk=16,
        conv_kernel=4,
        dtype="float32",
    )
