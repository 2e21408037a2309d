"""The flash kernel's two variants (repro_torch.kernels.flash_attention).

``variant(dtype, hd)`` alone decides which CUDA kernel runs: ``wgmma`` (bf16
at head dim 64 or 128, tiles of 128 q rows by 128 keys, and at head dim
256, tiles of 128 q rows by 64 keys) or ``simt`` (everything else).  The
tile decides what a row with no live key outputs, so the plain version
tiles as the chosen kernel does; here its bf16 path at the wgmma tiles is
held against the Pallas kernel (interpret mode) at the same block_q and
block_k and against the JAX oracle, with the bf16 tolerance of
tests/test_kernels.py.  The kernels themselves run only on the card
(``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ops import flash_mha as jax_flash_mha
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import block_shape, check_args, variant

TOL = dict(rtol=2e-2, atol=2e-2)  # bf16, tests/test_kernels.py


def _inputs(seed, B, Sq, Sk, H, KV, hd):
    """The same numpy draws as bf16 JAX arrays and bf16 torch tensors."""
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, Sq, H, hd), dtype=np.float32),
              rng.standard_normal((B, Sk, KV, hd), dtype=np.float32),
              rng.standard_normal((B, Sk, KV, hd), dtype=np.float32))
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, ("wgmma", (128, 128))),
    (torch.bfloat16, 128, ("wgmma", (128, 128))),
    (torch.bfloat16, 16, ("simt", (64, 64))),
    (torch.bfloat16, 96, ("simt", (64, 64))),
    (torch.bfloat16, 256, ("wgmma", (128, 64))),
    (torch.float32, 64, ("simt", (64, 64))),
    (torch.float32, 128, ("simt", (64, 64))),
    (torch.float32, 256, ("simt", (32, 32))),
])
def test_variant_routing_table(dtype, hd, want):
    assert (variant(dtype, hd), block_shape(dtype, hd)) == want


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,kw", [
    (2, 256, 256, 4, 2, 64, dict(causal=True)),                     # GQA
    (1, 256, 256, 4, 1, 128, dict(causal=True)),                    # MQA, wide head
    (1, 256, 256, 2, 2, 64, dict(causal=True, window=32)),
    (1, 256, 256, 2, 2, 64, dict(causal=True, window=100)),
    (2, 128, 128, 2, 2, 64, dict(causal=False, softcap=30.0)),
    (1, 128, 256, 4, 4, 64, dict(causal=False)),                    # Sq < Sk
    (1, 256, 128, 4, 2, 128, dict(causal=True)),                    # Sq > Sk
])
def test_bf16_plain_at_wgmma_tiles_matches_pallas(B, Sq, Sk, H, KV, hd, kw):
    (qj, kj, vj), (qt, kt, vt) = _inputs(B * Sq + Sk + hd, B, Sq, Sk, H, KV, hd)
    assert variant(qt.dtype, hd) == "wgmma"
    got = ops.flash_mha(qt, kt, vt, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    kernel = jax_flash(qj, kj, vj, block_q=128, block_k=128, **kw)
    np.testing.assert_allclose(_f32(got), _f32(kernel), **TOL)
    np.testing.assert_allclose(_f32(got), _f32(jax_ref.mha_reference(qj, kj, vj, **kw)), **TOL)


# Head dim 256 (gemma2-9b, gemma3-4b): the wgmma kernel's tiles of 128 q rows
# by 64 keys, held to the Pallas kernel at block_q = 128, block_k = 64.
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,kw", [
    (1, 256, 256, 4, 2, 256, dict(causal=True)),                            # GQA
    (1, 256, 256, 2, 2, 256, dict(causal=True, window=100)),
    (1, 256, 256, 4, 2, 256, dict(causal=True, softcap=50.0, scale=224.0**-0.5)),  # gemma2
    (1, 128, 256, 4, 1, 256, dict(causal=False)),                           # MQA, Sq < Sk
], ids=["gqa", "window", "softcap-scale", "mqa-unmasked"])
def test_bf16_plain_at_hd256_wgmma_tiles_matches_pallas(B, Sq, Sk, H, KV, hd, kw):
    (qj, kj, vj), (qt, kt, vt) = _inputs(B * Sq + Sk + hd, B, Sq, Sk, H, KV, hd)
    assert (variant(qt.dtype, hd), block_shape(qt.dtype, hd)) == ("wgmma", (128, 64))
    got = ops.flash_mha(qt, kt, vt, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    kernel = jax_flash(qj, kj, vj, block_q=128, block_k=64, **kw)
    np.testing.assert_allclose(_f32(got), _f32(kernel), **TOL)
    np.testing.assert_allclose(_f32(got), _f32(jax_ref.mha_reference(qj, kj, vj, **kw)), **TOL)


def test_rows_without_live_keys_follow_the_hd256_tile():
    """Sq > Sk with a window of 32, bf16 at hd 256: the 128-row q tile from 128
    meets only live k tile 1 (keys 64-127), so its rows from 159 on, whose
    keys are all masked, average those 64 keys' values; the q tile from 256
    meets no live tile and outputs 0.  With 128-key tiles those rows would
    average all 128 keys, and with the SIMT kernel's 32-row tiles rows
    160-255 would give 0: the Pallas kernel at block_q 128, block_k 64
    decides."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(9, 1, 384, 128, 2, 1, 256)
    got = ops.flash_mha(qt, kt, vt, causal=True, window=32)
    kernel = jax_flash(qj, kj, vj, causal=True, window=32, block_q=128, block_k=64)
    np.testing.assert_allclose(_f32(got), _f32(kernel), **TOL)
    mean_v = vt[0, 64:, 0].float().mean(0)
    assert (mean_v - vt[0, :, 0].float().mean(0)).abs().max() > 0.1
    for r in (159, 200, 255):
        for h in range(2):
            np.testing.assert_allclose(_f32(got[0, r, h]), mean_v.numpy(), **TOL)
    assert not got[:, 256:].any()


@pytest.mark.parametrize("Sq,Sk,causal", [(300, 300, True), (200, 330, False)])
def test_bf16_plain_at_wgmma_tiles_ragged(Sq, Sk, causal):
    """Lengths the 128 tile does not divide (the Pallas kernel needs divisors,
    so the oracle, which JAX's ops.flash_mha falls back to, is the reference)."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(Sq + Sk, 1, Sq, Sk, 4, 2, 64)
    got = ops.flash_mha(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(jax_ref.mha_reference(qj, kj, vj, causal=causal)),
                               **TOL)
    np.testing.assert_allclose(_f32(got), _f32(jax_flash_mha(qj, kj, vj, causal=causal)), **TOL)


def test_rows_without_live_keys_follow_the_wgmma_tile():
    """Sq > Sk with a window of 32, bf16 at hd 64: the 128-row q tile from 128
    meets live k tile 0, so its rows from 159 on, whose keys are all masked,
    average tile 0's values; the q tile from 256 meets no live tile and
    outputs 0.  With the SIMT kernel's 64-row tiles, rows 192-255 would meet
    none and give 0 instead: the Pallas kernel at 128-row blocks decides."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(8, 1, 384, 128, 2, 1, 64)
    got = ops.flash_mha(qt, kt, vt, causal=True, window=32)
    kernel = jax_flash(qj, kj, vj, causal=True, window=32, block_q=128, block_k=128)
    np.testing.assert_allclose(_f32(got), _f32(kernel), **TOL)
    mean_v = vt[0, :, 0].float().mean(0)
    for r in (159, 200, 255):
        for h in range(2):
            np.testing.assert_allclose(_f32(got[0, r, h]), mean_v.numpy(), **TOL)
    assert got[:, 192:256].abs().sum() > 0 and not got[:, 256:].any()


@pytest.mark.parametrize("dtype,match", [(torch.bfloat16, "16-byte aligned"),
                                         (torch.float32, "CUDA")])
def test_check_args_rejects_a_misaligned_view_for_wgmma(dtype, match):
    """A contiguous view that starts one element into its storage: the wgmma
    kernel's 16-byte copies need aligned bases and it raises; the SIMT kernel
    reads elements and takes it (here it stops at the device check)."""
    B, S, H, hd = 1, 64, 2, 64
    q = torch.zeros(1 + B * S * H * hd, dtype=dtype)[1:].view(B, S, H, hd)
    assert q.is_contiguous() and q.data_ptr() % 16
    kv = torch.zeros(B, S, H, hd, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        check_args(q, kv, kv, None)
