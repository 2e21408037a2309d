"""Rotary position embeddings (counterpart of ``repro/models/rope.py``).

M-RoPE (qwen2-vl) arrives with the VLM slice.
"""

from __future__ import annotations

import torch


def position_tensor(pos, device) -> torch.Tensor:
    """A decode position as a 0-d int64 tensor on ``device``: a tensor as it
    is (moved or widened if it lies elsewhere or is narrower, as an int32
    position is), an int filled there by a kernel, with no copy from the
    host."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.long)
    return torch.full((), pos, dtype=torch.long, device=device)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim/2] inverse frequencies (fp32)."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions [...] -> angles [..., head_dim/2] (fp32)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    return positions.float()[..., None] * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [..., S, n, head_dim] (or [..., S, head_dim]); angles [..., S, head_dim/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if angles.ndim == x.ndim - 1:  # broadcast over the head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles).to(x.dtype), torch.sin(angles).to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
