"""The port's kernel modules (repro_torch.kernels) against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the Pallas kernels (interpret mode) and the ``ref.py`` oracles
of the JAX package, on the same inputs made with numpy, with the tolerances
of tests/test_kernels.py.  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` holds them against these plain versions there).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ops import flash_mha as jax_flash_mha
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm, variant as rmsnorm_variant

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _qkv(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, KV, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, KV, hd), dtype=np.float32))


def _both(arrays, dtype):
    """The same numpy inputs as JAX arrays and as torch tensors of ``dtype``."""
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _check_flash(arrays, dtype, block, **kw):
    """Port (plain path of ops.flash_mha, and ref) vs the Pallas kernel and JAX ref."""
    (qj, kj, vj), (qt, kt, vt) = _both(arrays, dtype)
    got = ops.flash_mha(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    kernel = jax_flash(qj, kj, vj, block_q=block, block_k=block, **kw)
    oracle = jax_ref.mha_reference(qj, kj, vj, **kw)
    np.testing.assert_allclose(_f32(got), _f32(kernel), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])
    np.testing.assert_allclose(_f32(ref.mha_reference(qt, kt, vt, **kw)), _f32(oracle),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,KV,hd,block",
    [
        (1, 128, 2, 2, 64, 128),    # MHA
        (2, 256, 4, 2, 64, 128),    # GQA
        (1, 256, 4, 1, 128, 128),   # MQA, wide head
        (2, 512, 2, 2, 64, 256),    # bigger blocks
    ],
)
def test_flash_causal_sweep(dtype, B, S, H, KV, hd, block):
    _check_flash(_qkv(0, B, S, S, H, KV, hd), dtype, block, causal=True)


@pytest.mark.parametrize("window", [32, 100, 512])
def test_flash_window(window):
    _check_flash(_qkv(1, 1, 256, 256, 2, 2, 64), "float32", 128, causal=True, window=window)


def test_flash_softcap_and_noncausal():
    _check_flash(_qkv(2, 2, 128, 128, 2, 2, 64), "float32", 128, causal=False, softcap=30.0)


def test_flash_cross_lengths():
    """Sq != Sk (cross-attention shape)."""
    _check_flash(_qkv(3, 1, 128, 256, 4, 4, 64), "float32", 128, causal=False)


def test_flash_scale_argument():
    _check_flash(_qkv(4, 1, 128, 128, 4, 2, 64), "float32", 128, causal=True, scale=0.3)


@pytest.mark.parametrize("Sq,Sk,causal", [(96, 96, False), (300, 300, True), (100, 200, True)])
def test_flash_ragged_lengths(Sq, Sk, causal):
    """Lengths no tile divides: the port masks the ragged tiles; JAX's ops.flash_mha
    falls back to its oracle there."""
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(5, 1, Sq, Sk, 4, 2, 64), "float32")
    got = ops.flash_mha(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(jax_flash_mha(qj, kj, vj, causal=causal)),
                               **TOL["float32"])


def test_flash_rows_without_live_keys_are_zero():
    """Sq > Sk with a window: late rows meet no live k block and output 0, as in the
    Pallas kernel at the port's tile size (not the oracle's uniform average)."""
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(6, 1, 384, 128, 2, 2, 64), "float32")
    got = ops.flash_mha(qt, kt, vt, causal=True, window=32)
    kernel = jax_flash(qj, kj, vj, causal=True, window=32, block_q=64, block_k=64)
    np.testing.assert_allclose(_f32(got), _f32(kernel), **TOL["float32"])
    assert not got[:, 256:].any()


def test_flash_rows_without_live_keys_follow_wide_head_tiles():
    """hd > 128 tiles by 32 in the kernel, and so in its plain version: row 95
    meets a live tile with every key masked (uniform average), rows from 96 on
    meet none (0), as in the Pallas kernel with 32-row blocks."""
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(7, 1, 192, 64, 2, 1, 256), "float32")
    got = ops.flash_mha(qt, kt, vt, causal=True, window=32)
    kernel = jax_flash(qj, kj, vj, causal=True, window=32, block_q=32, block_k=32)
    np.testing.assert_allclose(_f32(got), _f32(kernel), **TOL["float32"])
    assert got[:, 95].abs().sum() > 0 and not got[:, 96:].any()


@pytest.mark.parametrize("rows", [1, 4, 37, 256])
@pytest.mark.parametrize("d", [64, 256, 1024])
def test_rmsnorm_sweep(rows, d):
    rng = np.random.default_rng(rows * d)
    x = rng.standard_normal((rows, d), dtype=np.float32)
    s = np.full((d,), rng.uniform(0.5, 2.0), np.float32)
    (xj, sj), (xt, st) = _both((x, s), "float32")
    got = ops.fused_rmsnorm(xt, st)
    for want in (jax_rmsnorm(xj, sj), jax_ref.rmsnorm_reference(xj, sj)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(ref.rmsnorm_reference(xt, st)), _f32(got),
                               rtol=1e-5, atol=1e-5)


def test_rmsnorm_bf16_and_3d():
    x = np.random.default_rng(0).standard_normal((2, 8, 128), dtype=np.float32)
    (xj,), (xt,) = _both((x,), "bfloat16")
    s = np.ones((128,), np.float32)
    got = ops.fused_rmsnorm(xt, torch.from_numpy(s))
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    for want in (jax_rmsnorm(xj, jnp.asarray(s)), jax_ref.rmsnorm_reference(xj, jnp.asarray(s))):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)


def _at_offset(shape, dtype, elements):
    """A contiguous tensor of ``shape`` that starts ``elements`` into its storage."""
    return torch.zeros(elements + int(np.prod(shape)), dtype=dtype)[elements:].view(shape)


@pytest.mark.parametrize("dtype,shape,x_offset,scale_offset,want", [
    (torch.bfloat16, (65536, 128), 0, 0, "vector"),  # qk-norm: 16 vectors a row
    (torch.bfloat16, (4, 2560), 0, 0, "vector"),     # qwen3-4b ln at decode
    (torch.bfloat16, (8192, 2048), 0, 0, "vector"),  # mamba2 gated norm
    (torch.float32, (37, 1024), 0, 0, "vector"),
    (torch.float32, (2, 4, 4), 0, 0, "vector"),      # D = one fp32 vector
    (torch.bfloat16, (2, 4, 4), 0, 0, "scalar"),     # D = half a bf16 vector
    (torch.bfloat16, (37, 1020), 0, 0, "scalar"),    # D not a multiple of 8
    (torch.float32, (37, 1022), 0, 0, "scalar"),     # D not a multiple of 4
    (torch.bfloat16, (64, 2560), 1, 0, "scalar"),    # x 2 bytes past 16-byte alignment
    (torch.bfloat16, (64, 2560), 8, 0, "vector"),    # x 16 bytes in: aligned
    (torch.float32, (64, 1024), 0, 1, "scalar"),     # scale 4 bytes past alignment
])
def test_rmsnorm_variant_routing_table(dtype, shape, x_offset, scale_offset, want):
    """``variant`` routes by D and alignment alone; the served shapes take
    16-byte vectors."""
    x = _at_offset(shape, dtype, x_offset)
    scale = _at_offset((shape[-1],), torch.float32, scale_offset)
    assert (x.data_ptr() % 16 == 0) == (x_offset * x.element_size() % 16 == 0)
    assert rmsnorm_variant(x, scale) == want


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    x = torch.randn(4, 64)
    ops.fused_rmsnorm(x, torch.ones(64))
    q = torch.randn(1, 64, 2, 64)
    ops.flash_mha(q, q, q)
    ops.ssd(torch.randn(1, 70, 2, 8), torch.rand(1, 70, 2), -torch.ones(2),
            torch.randn(1, 70, 1, 4), torch.randn(1, 70, 1, 4))
    assert ops.launch_counts() == {"rmsnorm": 0, "rmsnorm/vector": 0, "rmsnorm/scalar": 0,
                                  "rmsnorm_bwd": 0, "rmsnorm_bwd/vector": 0,
                                  "rmsnorm_bwd/scalar": 0, "flash_attention": 0,
                                  "flash_attention/wgmma": 0, "flash_attention/simt": 0,
                                  "flash_attention_bwd": 0, "flash_attention_bwd/wgmma": 0,
                                  "flash_attention_bwd/mma": 0,
                                  "flash_attention_bwd/simt": 0,
                                  "ssd_scan": 0, "ssd_scan/tc": 0, "ssd_scan/simt": 0}


def test_import_and_cpu_path_need_no_nvcc():
    code = (
        "import torch\n"
        "from repro_torch.kernels import _build, ops\n"
        "ops.fused_rmsnorm(torch.ones(2, 8), torch.ones(8))\n"
        "ops.flash_mha(torch.ones(1, 4, 2, 16), torch.ones(1, 4, 1, 16), torch.ones(1, 4, 1, 16))\n"
        "ops.ssd(torch.ones(1, 4, 2, 8), torch.ones(1, 4, 2), -torch.ones(2), torch.ones(1, 4, 1, 4),"
        " torch.ones(1, 4, 1, 4))\n"
        "assert not _build._LIBS\n"
    )
    env = dict(os.environ, PATH="", CUDA_HOME=str(ROOT / "no-cuda-here"),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.randn(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(x, torch.ones(64))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rmsnorm(x.half(), torch.ones(64))
    with pytest.raises(ValueError, match="scale"):
        rmsnorm(x, torch.ones(32))
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(torch.randn(64, 4).T, torch.ones(64))
    # Both variants' inputs pass the layout checks and stop at the device check.
    for xs in (_at_offset((4, 64), torch.bfloat16, 1), _at_offset((4, 60), torch.bfloat16, 0)):
        assert rmsnorm_variant(xs, torch.ones(xs.shape[-1])) == "scalar"
        with pytest.raises(ValueError, match="CUDA tensors"):
            rmsnorm(xs, torch.ones(xs.shape[-1]))
    q = torch.randn(1, 64, 4, 64)
    kv = torch.randn(1, 64, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(torch.randn(1, 8, 2, 24), torch.randn(1, 8, 2, 24),
                        torch.randn(1, 8, 2, 24))
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(torch.randn(1, 8, 1, 272), torch.randn(1, 8, 1, 272),
                        torch.randn(1, 8, 1, 272))
    with pytest.raises(ValueError, match="mismatched"):
        flash_attention(torch.randn(1, 8, 3, 64), kv[:, :8], kv[:, :8])
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), kv, kv)
    with pytest.raises(ValueError, match="device"):
        ops.fused_rmsnorm(torch.empty(4, 64, device="meta"), torch.ones(64, device="meta"))
