"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against ``repro.models.mla`` on the CPU, at deepseek-v2-lite's smoke widths
in fp32: the decompressed attention, prefill with its compressed cache, and
the absorbed decode step against that cache.  Tolerance: fp32 2e-5 relative
to the largest reference value, as ``tests/test_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import mla as jax_mla
from repro.models import rope as jax_rope
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model, mla, rope
from repro_torch.models.convert import params_from_jax

TOL = 2e-5
ARCH = "deepseek-v2-lite-16b"


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _setup():
    """(jax cfg, port cfg, spec, layer 0's MLA params on both sides)."""
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jcfg.program[0][0][0], jparams["blocks"][0]["l0"]["attn"], \
        tparams["blocks"][0]["attn"]


def _angles(cfg, pos):
    """Angles at qk_rope on both sides, as ``Model._angles`` takes them for MLA."""
    hd = cfg.qk_rope_head_dim
    return (jax_rope.rope_angles(jnp.asarray(pos), hd, cfg.rope_theta),
            rope.rope_angles(torch.from_numpy(np.ascontiguousarray(pos)), hd, cfg.rope_theta))


def test_rope_rotates_the_headless_rope_key():
    """k_rope [B, S, rope] has no head axis: angles of x's rank are not
    broadcast, as in the reference."""
    x = np.random.default_rng(0).standard_normal((2, 9, 8), dtype=np.float32)
    ja, ta = _angles(get_smoke_config(ARCH), np.broadcast_to(np.arange(9), (2, 9)))
    assert ta.shape == (2, 9, 4)
    got = rope.apply_rope(torch.from_numpy(x), ta)
    assert _rel(got, jax_rope.apply_rope(jnp.asarray(x), ja)) < 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_apply_mla_matches_jax(causal):
    jcfg, tcfg, spec, jp, tp = _setup()
    x = np.random.default_rng(1).standard_normal((2, 11, jcfg.d_model), dtype=np.float32)
    ja, ta = _angles(jcfg, np.broadcast_to(np.arange(11), (2, 11)))
    got = mla.apply_mla(tp, torch.from_numpy(x), tcfg, spec, ta, causal=causal)
    want = jax_mla.apply_mla(jp, jnp.asarray(x), jcfg, spec, ja, causal=causal)
    assert got.shape == x.shape and _rel(got, want) < TOL


def test_prefill_and_absorbed_decode_match_jax():
    """Prefill's output and its compressed cache (zero beyond the prompt),
    then 4 absorbed decode steps, each output and both cache leaves."""
    jcfg, tcfg, spec, jp, tp = _setup()
    B, S, max_seq = 2, 9, 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, jcfg.d_model), dtype=np.float32)
    ja, ta = _angles(jcfg, np.broadcast_to(np.arange(S), (B, S)))
    jout, jcache = jax_mla.prefill_mla(jp, jnp.asarray(x), jcfg, spec, ja, max_seq)
    tout, tcache = mla.prefill_mla(tp, torch.from_numpy(x), tcfg, spec, ta, max_seq)
    assert _rel(tout, jout) < TOL
    assert tcache["c_kv"].shape == (B, max_seq, jcfg.kv_lora_rank)
    assert tcache["k_rope"].shape == (B, max_seq, jcfg.qk_rope_head_dim)
    for name in ("c_kv", "k_rope"):
        assert _rel(tcache[name], jcache[name]) < TOL, name
        assert not tcache[name][:, S:].any()
    for i in range(4):
        pos = S + i
        x1 = rng.standard_normal((B, 1, jcfg.d_model), dtype=np.float32)
        ja, ta = _angles(jcfg, np.full((B, 1), pos))
        jout, jcache = jax_mla.decode_mla(jp, jnp.asarray(x1), jcache, jnp.int32(pos), jcfg,
                                          spec, ja)
        tout, tcache = mla.decode_mla(tp, torch.from_numpy(x1), tcache, torch.tensor(pos), tcfg,
                                      spec, ta)
        assert tout.shape == (B, 1, jcfg.d_model) and _rel(tout, jout) < TOL, f"step {i}"
        for name in ("c_kv", "k_rope"):
            assert _rel(tcache[name], jcache[name]) < TOL, (name, i)


def test_decode_reads_the_cache_in_place():
    """The absorbed step multiplies against the position-major cache as it
    lies: no op allocates a tensor as large as a layer's c_kv, and the
    cache tensors are the ones passed in."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = get_smoke_config(ARCH)
    spec = cfg.program[0][0][0]
    p = mla.init_mla(torch.Generator().manual_seed(0), cfg, spec)
    B, W, pos = 2, 64, 40
    cache = mla.init_mla_cache(cfg, B, W, torch.float32, "cpu")
    c_kv = cache["c_kv"]
    x = torch.randn(B, 1, cfg.d_model, generator=torch.Generator().manual_seed(1))
    _, ta = _angles(cfg, np.full((B, 1), pos))
    fresh = []

    class Allocations(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            inputs = {a.untyped_storage().data_ptr() for a in args if isinstance(a, torch.Tensor)}
            if isinstance(out, torch.Tensor) and out.untyped_storage().data_ptr() not in inputs:
                fresh.append((str(func), out.numel()))
            return out

    with Allocations():
        _, out_cache = mla.decode_mla(p, x, cache, torch.tensor(pos), cfg, spec, ta)
    assert out_cache["c_kv"] is c_kv and c_kv[:, pos].any()
    assert fresh and max(n for _, n in fresh) < c_kv.numel(), fresh


def test_mla_scale_and_rope_dim():
    """Scores scale by 1/sqrt(qk_nope + qk_rope) = 1/sqrt(192) at full
    width, and the model takes its angles at qk_rope."""
    cfg = get_config(ARCH)
    assert mla._mla_scale(cfg) == pytest.approx(192 ** -0.5, rel=1e-15)
    model = build_model(get_smoke_config(ARCH), "cpu")
    angles = model._angles(torch.arange(5).expand(2, 5))
    assert angles.shape == (2, 5, get_smoke_config(ARCH).qk_rope_head_dim // 2)
