"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attention + mamba heads.  [arXiv:2411.13676; hf]

Each layer runs attention and a Mamba-2 mixer *in parallel* on the same
normed input; branch outputs are RMS-normed and averaged.  Sliding-window
(1024) attention everywhere except three global layers (first / middle /
last), matching the paper's layout.  head_dim=64; d_inner=3200 (50 SSM heads
of dim 64).  Sub-quadratic decode -> runs the long_500k cell (window ring
caches + constant SSM state; the 3 global layers keep full caches).

A copy of ``repro/configs/hymba_1_5b.py``: 1,589,773,120 parameters, 3.18 GB
in bf16 with the norms and the Mamba-2 vectors kept in fp32.
"""

from .base import LayerSpec, ModelConfig

_HG = LayerSpec(attn="hybrid", ffn="dense")                  # global attn + ssm
_HL = LayerSpec(attn="hybrid", ffn="dense", window=1024)     # windowed + ssm


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32_001,
        program=(
            ((_HG,), 1),
            ((_HL,), 15),
            ((_HG,), 1),
            ((_HL,), 14),
            ((_HG,), 1),
        ),
        ssm_state=16,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_chunk=64,
        conv_kernel=4,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    hg = LayerSpec(attn="hybrid", ffn="dense")
    hl = LayerSpec(attn="hybrid", ffn="dense", window=16)
    return ModelConfig(
        name="hymba-smoke",
        family="hybrid",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        program=(((hg,), 1), ((hl,), 2), ((hg,), 1)),
        ssm_state=8,
        ssm_expand=2,
        ssm_headdim=16,
        ssm_chunk=16,
        conv_kernel=4,
        dtype="float32",
    )
