"""The port's serving slice (repro_torch) against the JAX model on the CPU.

The JAX package's ``Model.init`` parameters are carried into the port with
``params_from_jax``; both sides get the same numpy prompt and are compared
module by module and end to end: prefill logits, every layer's K/V cache,
decode-step logits and the greedy tokens.  Also: the port imports nothing
of JAX or of ``repro``, and its entry point runs on CUDA unless asked for
the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models import rope as jax_rope
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention, build_model, layers, rope
from repro_torch.models.convert import cache_from_jax, kv_from_jax, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-4b"


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _configs(dtype):
    return (jax_smoke_config(ARCH).reduced(dtype=dtype),
            get_smoke_config(ARCH).reduced(dtype=dtype))


def _jax_and_port(dtype):
    jcfg, tcfg = _configs(dtype)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jmodel, jparams, build_model(tcfg, "cpu"), tparams


# ------------------------------------------------------- module by module
def test_rope_matches_jax():
    pos = np.arange(24).reshape(2, 12)
    x = np.random.default_rng(0).standard_normal((2, 12, 4, 16), dtype=np.float32)
    ja = jax_rope.rope_angles(jnp.asarray(pos), 16, 1e6)
    ta = rope.rope_angles(torch.from_numpy(pos), 16, 1e6)
    assert _rel(ta, ja) < 1e-6
    got = rope.apply_rope(torch.from_numpy(x), ta)
    assert _rel(got, jax_rope.apply_rope(jnp.asarray(x), ja)) < 1e-5


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_layers_match_jax(dtype, tol):
    jmodel, jparams, _, tparams = _jax_and_port(dtype)
    jcfg, tcfg = jmodel.cfg, _configs(dtype)[1]
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["l0"])  # layer 0 of the scan
    tp = tparams["blocks"][0]
    x = np.random.default_rng(1).standard_normal((2, 5, jcfg.d_model), dtype=np.float32)
    xj, xt = jnp.asarray(x, jcfg.dtype), torch.from_numpy(x).to(layers.dtype_of(tcfg))
    assert _rel(layers.apply_norm(tp["ln1"], xt, tcfg), jax_layers.apply_norm(jp["ln1"], xj, jcfg)) < tol
    assert _rel(layers.apply_dense_ffn(tp["ffn"], xt, tcfg),
                jax_layers.apply_dense_ffn(jp["ffn"], xj, jcfg)) < tol
    tok = np.array([[1, 7, 300]])
    assert _rel(layers.embed_tokens(tparams["embed"], torch.from_numpy(tok), tcfg),
                jax_layers.embed_tokens(jparams["embed"], jnp.asarray(tok), jcfg)) < tol
    assert _rel(layers.lm_logits(tparams["embed"], xt, tcfg),
                jax_layers.lm_logits(jparams["embed"], xj, jcfg)) < tol


@pytest.mark.parametrize(
    "dtype,tol,max_seq",
    [("float32", 1e-5, 16), ("bfloat16", 2e-2, 16), ("float32", 1e-5, 6)],
    ids=["fp32", "bf16", "fp32-ring"],
)
def test_attention_matches_jax(dtype, tol, max_seq):
    """prefill_attention (flash path) and decode_attention against the JAX module;
    max_seq < S keeps the last max_seq positions in a ring, as the reference does."""
    jmodel, jparams, _, tparams = _jax_and_port(dtype)
    jcfg, tcfg = jmodel.cfg, _configs(dtype)[1]
    spec = jcfg.program[0][0][0]
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["l0"]["attn"])
    tp = tparams["blocks"][0]["attn"]
    S = 9
    x = np.random.default_rng(2).standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    xj, xt = jnp.asarray(x, jcfg.dtype), torch.from_numpy(x).to(layers.dtype_of(tcfg))
    pos = np.broadcast_to(np.arange(S), (2, S))
    ja = jax_rope.rope_angles(jnp.asarray(pos), jcfg.head_dim, jcfg.rope_theta)
    ta = rope.rope_angles(torch.from_numpy(pos.copy()), tcfg.head_dim, tcfg.rope_theta)
    jout, jcache = jax_attention.prefill_attention(jp, xj, jcfg, spec, ja, max_seq)
    tout, tcache = attention.prefill_attention(tp, xt, tcfg, spec, ta, max_seq)
    assert _rel(tout, jout) < tol
    for name in ("k", "v"):
        assert _rel(tcache[name], kv_from_jax(jcache[name])) < tol
    x1 = x[:, :1] * 0.5
    a1 = np.full((2, 1), S)
    jout, jcache = jax_attention.decode_attention(
        jp, jnp.asarray(x1, jcfg.dtype), jcache, jnp.int32(S), jcfg, spec,
        jax_rope.rope_angles(jnp.asarray(a1), jcfg.head_dim, jcfg.rope_theta))
    tout, tcache = attention.decode_attention(
        tp, torch.from_numpy(x1).to(layers.dtype_of(tcfg)), tcache, torch.tensor(S), tcfg, spec,
        rope.rope_angles(torch.from_numpy(a1), tcfg.head_dim, tcfg.rope_theta))
    assert _rel(tout, jout) < tol
    for name in ("k", "v"):
        assert _rel(tcache[name], kv_from_jax(jcache[name])) < tol


def test_decode_attention_does_not_copy_the_cache():
    """A decode step reads the head-major cache through views: no op in it
    allocates a tensor as large as one layer's K or V cache."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = get_smoke_config(ARCH)
    spec = cfg.program[0][0][0]
    p = attention.init_attention(torch.Generator().manual_seed(0), cfg, spec)
    B, W, pos = 2, 64, 40
    cache = attention.init_kv_cache(cfg, spec, B, W, layers.dtype_of(cfg), "cpu")
    x = torch.randn(B, 1, cfg.d_model, generator=torch.Generator().manual_seed(1))
    angles = rope.rope_angles(torch.full((B, 1), pos), cfg.head_dim, cfg.rope_theta)
    fresh = []

    class Allocations(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            inputs = {a.untyped_storage().data_ptr() for a in args if isinstance(a, torch.Tensor)}
            if isinstance(out, torch.Tensor) and out.untyped_storage().data_ptr() not in inputs:
                fresh.append((str(func), out.numel()))
            return out

    with Allocations():
        attention.decode_attention(p, x, cache, torch.tensor(pos), cfg, spec, angles)
    assert fresh and max(n for _, n in fresh) < cache["k"].numel(), fresh


# ------------------------------------------------------------ end to end
@pytest.mark.parametrize(
    "dtype,spare,tol",
    [("float32", 0, 1e-5), ("bfloat16", 0, 2e-2), ("float32", 20, 1e-5)],
    ids=["fp32", "bf16", "fp32-long-cache"],
)
def test_serving_matches_jax_model(dtype, spare, tol):
    """Prefill + 4 greedy decode steps; ``spare`` cache slots beyond the last
    decoded position keep zero padding under the written_at >= 0 mask."""
    jmodel, jparams, tmodel, tparams = _jax_and_port(dtype)
    B, P, steps = 2, 12, 4
    max_seq = P + steps + spare
    tokens = np.random.default_rng(3).integers(0, jmodel.cfg.vocab_size, (B, P))
    jprefill = jax.jit(lambda p, b: jmodel.prefill(p, b, max_seq=max_seq))
    jdecode = jax.jit(jmodel.decode_step)
    jlogits, jcache = jprefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tlogits, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, max_seq)
    assert tlogits.shape == (B, 1, jmodel.cfg.vocab_size)
    empty = tmodel.init_cache(B, max_seq)
    assert [c["kv"]["k"].shape for c in empty] == [c["kv"]["k"].shape for c in tcache]

    def check_caches():
        jlayers = cache_from_jax(jcache, jmodel.cfg)
        assert len(jlayers) == len(tcache) == jmodel.cfg.num_layers
        for jl, tl in zip(jlayers, tcache):
            for name in ("k", "v"):
                assert _rel(tl["kv"][name], jl["kv"][name]) < tol

    check_caches()
    for i in range(steps):
        assert _rel(tlogits, jlogits) < tol, f"step {i}"
        jtok = np.array(jnp.argmax(jlogits[:, -1], axis=-1))[:, None]
        ttok = tlogits[:, -1].argmax(-1, keepdim=True)
        if dtype == "float32":
            np.testing.assert_array_equal(ttok.numpy(), jtok)
        # Both sides continue from the reference's tokens, so a bf16 near-tie
        # cannot fork the two sequences.
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(jtok, jnp.int32), jnp.int32(P + i))
        tlogits, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(jtok), P + i)
    assert _rel(tlogits, jlogits) < tol
    check_caches()


def test_cpu_serving_launches_no_kernel():
    ops.reset_launch_counts()
    gen = serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
                      "--gen", "4"])
    assert gen.shape == (2, 4) and gen.dtype == torch.int64
    assert 0 <= int(gen.min()) and int(gen.max()) < get_smoke_config(ARCH).vocab_size
    assert ops.launch_counts() == {"rmsnorm": 0, "rmsnorm/vector": 0, "rmsnorm/scalar": 0,
                                  "rmsnorm_bwd": 0, "rmsnorm_bwd/vector": 0,
                                  "rmsnorm_bwd/scalar": 0, "flash_attention": 0,
                                  "flash_attention/wgmma": 0, "flash_attention/simt": 0,
                                  "flash_attention_bwd": 0, "flash_attention_bwd/wgmma": 0,
                                  "flash_attention_bwd/mma": 0,
                                  "flash_attention_bwd/simt": 0,
                                  "ssd_scan": 0, "ssd_scan/tc": 0, "ssd_scan/simt": 0}


def test_entry_point_defaults_to_cuda():
    """On a host without CUDA the default device raises instead of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would serve on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--batch", "1", "--prompt-len", "4", "--gen", "2"])


def test_registry():
    assert list_archs() == [ARCH, "mamba2-370m"]
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size) == (36, 2560, 32, 8, 128, 9728, 151_936)
    with pytest.raises(KeyError, match="not yet ported"):
        get_config("gemma2-9b")


def test_unported_layers_raise():
    from repro_torch.configs.base import LayerSpec, uniform_program

    cfg = get_smoke_config(ARCH).reduced(program=uniform_program(LayerSpec(attn="window",
                                                                           window=8), 3))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, "cpu")


# ------------------------------------------------------------ import hygiene
def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_nothing_of_jax_or_repro():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if n.split(".")[0] in ("jax", "repro")]
    assert not bad, bad


def test_port_imports_with_jax_poisoned():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'repro_torch.launch.serve' in names and 'repro_torch.kernels.ops' in names\n"
        f"assert set({NEW_MODULES!r}) <= set(names), set({NEW_MODULES!r}) - set(names)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    # The framework-free ports (the runtime with its tenants, the tuners,
    # observability, the verifiers, the plan IR) import no torch either.
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'repro', 'torch'):\n"
        "    sys.modules[m] = None\n"
        f"for n in {FRAMEWORK_FREE!r}:\n"
        "    importlib.import_module(n)\n"
        "assert not any(m.startswith('repro_torch.models') for m in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


NEW_MODULES = ("repro_torch.launch.colocate", "repro_torch.runtime.tenants", "repro_torch.tune",
               "repro_torch.tune.budget", "repro_torch.tune.lanes", "repro_torch.tune.objective",
               "repro_torch.tune.victim", "repro_torch.obs", "repro_torch.obs.cli",
               "repro_torch.obs.metrics", "repro_torch.obs.monitor", "repro_torch.obs.recorder",
               "repro_torch.obs.sketch", "repro_torch.obs.trace_export",
               "repro_torch.obs.windows", "repro_torch.analyze.schedule_check",
               "repro_torch.analyze.driver")
FRAMEWORK_FREE = ("repro_torch.runtime", "repro_torch.runtime.tenants", "repro_torch.tune",
                  "repro_torch.obs", "repro_torch.analyze", "repro_torch.plan")
