"""whisper-large-v3 [audio]: enc-dec, 32L+32L d_model=1280 20H d_ff=5120
vocab=51866.  [arXiv:2212.04356; unverified]

The conv frontend is a STUB per the assignment: ``input_specs()`` provides
post-conv frame embeddings [B, 1500, 1280].  LayerNorm + GELU MLP as in the
original; sinusoidal positions on both stacks (deviation: whisper's decoder
positions are learned — recorded in DESIGN.md).  Decoder layers cross-attend
the encoder output; decode shapes exercise the text decoder.

A copy of ``repro/configs/whisper_large_v3.py``: 1,535,219,200 parameters,
3.07 GB in bf16 with the LayerNorm scales and biases and the FFN biases
kept in fp32.
"""

from .base import LayerSpec, ModelConfig, uniform_program

_ENC = LayerSpec(attn="full", ffn="dense")
_DEC = LayerSpec(attn="full", ffn="dense", cross_attn=True)


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        num_layers=32,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51_866,
        program=uniform_program(_DEC, 32),
        is_encoder_decoder=True,
        enc_program=uniform_program(_ENC, 32),
        enc_seq=1500,
        frontend="audio_stub",
        ffn_act="gelu",
        norm_type="layer",
        norm_eps=1e-5,
        tie_embeddings=True,
        rope_theta=0.0,  # no rope; sinusoidal positions
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        program=uniform_program(_DEC, 2),
        is_encoder_decoder=True,
        enc_program=uniform_program(_ENC, 2),
        enc_seq=24,
        frontend="audio_stub",
        ffn_act="gelu",
        norm_type="layer",
        dtype="float32",
    )
