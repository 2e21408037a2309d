"""Model zoo of the port: the dense and MoE decoders, Mamba-2, the hybrid
(attention + Mamba-2) decoder, the vision-language decoder (qwen2-vl's
M-RoPE over the vision stub's patches), the encoder-decoder (whisper), and
the paper's CNNs."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from .cnn import CNN  # noqa: F401
from .encdec import EncDecModel
from .layers import NOT_PORTED
from .transformer import Model


def build_model(cfg: ModelConfig, device) -> Model | EncDecModel:
    """The model object for ``cfg`` on ``device`` (init/init_cache/prefill/decode_step):
    an ``EncDecModel`` for an encoder-decoder config, else a ``Model``."""
    if cfg.is_encoder_decoder:
        return EncDecModel(cfg, device)
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm"):
        raise NotImplementedError(f"{cfg.name} ({cfg.family}) {NOT_PORTED}")
    return Model(cfg, device)
