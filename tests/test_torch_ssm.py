"""The port's Mamba-2 slice (repro_torch) against the JAX package on the CPU.

The SSD scan's plain version (what ``ops.ssd`` runs on a CPU tensor) is held
against the Pallas kernel in interpret mode, the JAX oracle and the JAX
model's ``ssd_chunked``; the Mamba-2 mixer and the mamba2-370m smoke model
against the JAX model, with the JAX ``Model.init`` parameters carried over
by ``params_from_jax`` and the same numpy inputs on both sides.

The bf16 port is not held to the JAX bf16 model: that model's chunked SSD
takes its cumsum and decays in bf16 and is far from the exact recurrence at
chunk 256 (``test_bf16_ssd_stays_near_the_exact_recurrence``).  The port
follows the Pallas kernel, fp32 inside, and its bf16 model is held to the
JAX model run in fp32 on the same bf16-rounded parameters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ref as jax_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import CHUNK, check_args, ssd_scan, variant
from repro_torch.launch import serve
from repro_torch.models import build_model, ssm
from repro_torch.models.convert import cache_from_jax, params_from_jax

ARCH = "mamba2-370m"
SSD_TOL = 1e-4  # relative max error, tests/test_kernels.py::test_ssd_sweep


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ssd_inputs(seed, b, s, h, p, g, n, A=None, dt_shift=-3.0):
    """x, dt (post-softplus), A (< 0), Bm, Cm as float32 numpy arrays.

    dt = softplus(N(0, 1) + dt_shift): the default, about 0.05, decays the
    state by about e^-3 over a 64-step chunk, so what a chunk carries into the
    next one counts in y and in the final state (at dt about 0.7 it would
    have decayed to e^-45 and a wrong carry would pass unseen)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) + dt_shift)).astype(np.float32)
    if A is None:
        A = -np.exp(rng.standard_normal(h) * 0.3)
    Bm = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.5
    Cm = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.5
    return x, dt, np.asarray(A, np.float32), Bm, Cm


def _both(arrays, dtype="float32"):
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(np.array(a)).to(getattr(torch, dtype)) for a in arrays])


# ------------------------------------------------------------- the SSD scan
@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_plain_matches_pallas_kernel_and_oracle(chunk, g):
    """ops.ssd's plain version (64-step chunks) against the Pallas kernel at
    the JAX package's chunks, and both oracles against each other."""
    J, T = _both(_ssd_inputs(0, 2, 128, 4, 16, g, 8))
    y, state = ops.ssd(*T)
    assert y.shape == T[0].shape and state.shape == (2, 4, 16, 8) and state.dtype == torch.float32
    oracle = jax_ref.ssd_reference(*J)
    assert _rel(y, jax_ssd_scan(*J, chunk=chunk)) < SSD_TOL
    assert _rel(y, oracle) < SSD_TOL
    assert _rel(ref.ssd_reference(*T), oracle) < SSD_TOL


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_final_state_matches_model_ssd(g):
    """The final state (the decode cache's) against the JAX model's ssd_chunked."""
    J, T = _both(_ssd_inputs(1, 2, 96, 4, 16, g, 8))
    y, state = ops.ssd(*T)
    y_model, state_model = jax_ssm.ssd_chunked(*J, 16)
    assert _rel(y, y_model) < SSD_TOL
    assert _rel(state, state_model) < SSD_TOL


def test_ssd_length_not_a_chunk_multiple():
    """s = 100 is one full 64-step chunk and a ragged one: y against the oracle,
    the state against ssd_chunked on the input padded with dt = 0 (no-ops)."""
    arrays = _ssd_inputs(2, 1, 100, 4, 16, 1, 8)
    J, T = _both(arrays)
    y, state = ops.ssd(*T)
    assert 100 % CHUNK
    assert _rel(y, jax_ref.ssd_reference(*J)) < SSD_TOL
    x, dt, A, Bm, Cm = arrays
    padded = [np.pad(a, [(0, 0), (0, 12)] + [(0, 0)] * (a.ndim - 2)) for a in (x, dt, Bm, Cm)]
    _, state_model = jax_ssm.ssd_chunked(*(jnp.asarray(a) for a in padded[:2]), jnp.asarray(A),
                                         *(jnp.asarray(a) for a in padded[2:]), 16)
    assert _rel(state, state_model) < SSD_TOL


def test_bf16_ssd_stays_near_the_exact_recurrence():
    """mamba2's chunk is 256.  At b1 s512 h4 p16 n16 with A from -1 to -16
    (as init_mamba) and bf16 inputs, the port's SSD (fp32 inside, y rounded
    to bf16) stays within 1e-2 of the exact fp32 recurrence relative to
    max|y| (0.0020 measured, about one bf16 rounding).  The JAX model's bf16
    ssd_chunked, which takes its cumsum and decays in bf16, is off by more
    than 0.1 here (0.43 measured; the Pallas kernel, fp32 inside,
    0.0033): the reason the bf16 port is held to the
    JAX model in fp32 and not to its bf16 run."""
    arrays = _ssd_inputs(3, 1, 512, 4, 16, 1, 16, A=-np.linspace(1.0, 16.0, 4), dt_shift=0.0)
    arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    exact = jax_ref.ssd_reference(*(jnp.asarray(a) for a in arrays))
    Jb, Tb = _both(arrays, "bfloat16")
    y, _ = ops.ssd(*Tb)
    assert y.dtype == torch.bfloat16
    assert _rel(y, exact) < 1e-2
    assert _rel(jax_ssm.ssd_chunked(*Jb, 256)[0], exact) > 0.1


def test_ssd_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    _, T = _both(_ssd_inputs(4, 1, 8, 4, 16, 2, 8))
    x, dt, A, Bm, Cm = T
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(x, dt, A, Bm, Cm)
    # Views into one conv output, as apply_mamba hands them over, pass the
    # layout checks and fail only for lying on the CPU.
    xbc = torch.zeros(1, 8, 4 * 16 + 2 * 2 * 8)
    views = [t.unflatten(-1, shape) for t, shape in
             zip(xbc.split([64, 16, 16], dim=-1), ((4, 16), (2, 8), (2, 8)))]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan(views[0], dt, A, views[1], views[2])
    with pytest.raises(ValueError, match="share float32 or bfloat16"):
        ssd_scan(x, dt.bfloat16(), A, Bm, Cm)
    with pytest.raises(ValueError, match="mismatched"):
        ssd_scan(x, dt, A, Bm[:, :, :1].expand(1, 8, 3, 8), Cm[:, :, :1].expand(1, 8, 3, 8))
    with pytest.raises(ValueError, match="at most 128"):
        ssd_scan(torch.zeros(1, 8, 4, 160), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="want x"):
        ssd_scan(x, dt, A, Bm, Cm[..., :4])
    with pytest.raises(ValueError, match="device"):
        ops.ssd(*(t.to("meta") for t in T))
    # bf16 inputs of both variants pass the layout checks and stop at the
    # device check: dense ones (tc), and a view that starts one element into
    # its storage, which the tc kernel's 16-byte rows rule out (simt).
    xb = torch.zeros(1 + x.numel(), dtype=torch.bfloat16)[1:].view(x.shape)
    Tb = [t.bfloat16() for t in T]
    for args, want in ((Tb, "tc"), ([xb] + Tb[1:], "simt")):
        assert variant(args[0], args[3], args[4]) == want
        with pytest.raises(ValueError, match="CUDA tensors"):
            check_args(*args)
        with pytest.raises(ValueError, match="CUDA tensors"):
            ssd_scan(*args)


def _ssd_operands(dtype, p, n, layout):
    """x [2, 8, 4, p] and B, C [2, 8, 2, n] of ``dtype``: ``"dense"`` tensors,
    ``"views"`` into one [2, 8, 4 p + 4 n] conv output as apply_mamba hands
    them over, or ``"offset"`` views into a conv output one element wider
    that start one element in (so x, B and C are not 16-byte aligned and
    the sequence stride is odd)."""
    if layout == "dense":
        return torch.zeros(2, 8, 4, p, dtype=dtype), *torch.zeros(2, 2, 8, 2, n, dtype=dtype)
    offset = int(layout == "offset")
    xbc = torch.zeros(2, 8, offset + 4 * p + 4 * n, dtype=dtype)[..., offset:]
    return [t.unflatten(-1, shape) for t, shape in
            zip(xbc.split([4 * p, 2 * n, 2 * n], dim=-1), ((4, p), (2, n), (2, n)))]


@pytest.mark.parametrize("dtype,p,n,layout,want", [
    (torch.bfloat16, 64, 128, "views", "tc"),    # mamba2-370m
    (torch.bfloat16, 64, 128, "dense", "tc"),
    (torch.bfloat16, 128, 128, "dense", "tc"),   # the largest P and N
    (torch.bfloat16, 16, 8, "dense", "tc"),
    (torch.bfloat16, 8, 8, "views", "tc"),
    (torch.bfloat16, 12, 128, "dense", "simt"),  # P not a multiple of 8
    (torch.bfloat16, 64, 100, "dense", "simt"),  # N not a multiple of 8
    (torch.bfloat16, 64, 128, "offset", "simt"),  # not 16-byte aligned, odd stride
    (torch.bfloat16, 16, 8, "offset", "simt"),
    (torch.float32, 64, 128, "views", "simt"),   # fp32 keeps IEEE products
    (torch.float32, 128, 128, "dense", "simt"),
    (torch.float32, 16, 8, "dense", "simt"),
])
def test_ssd_variant_routing_table(dtype, p, n, layout, want):
    """``variant`` routes by type, P, N and layout alone; bf16 inputs that
    the tc kernel's 16-byte rows rule out go to simt, which the parent
    served them with, and pass ``check_args``."""
    x, Bm, Cm = _ssd_operands(dtype, p, n, layout)
    assert variant(x, Bm, Cm) == want
    dt = torch.zeros(2, 8, 4, dtype=dtype)
    with pytest.raises(ValueError, match="CUDA tensors"):
        check_args(x, dt, torch.zeros(4, dtype=dtype), Bm, Cm)


def _tc_emulation(x, dt, A, Bm, Cm):
    """The tc kernel's decomposition (csrc/ssd_scan_tc.cu) in PyTorch, with its
    bf16 roundings at the points its source note states: 64-step chunks,
    cumsum(dt A), every exp and every dt factor in fp32; the masked tile
    C B^T o exp(cum_i - cum_j) o dt_j, B o dt exp(cum_last - cum) and the
    state entering C state^T rounded to bf16 once each, as the second
    operand of their products; fp32 sums, and the carried state in fp32.
    x, dt, A, Bm, Cm are bf16 and enter the products as given."""
    bf = torch.bfloat16
    b, s, h, p = x.shape
    rep = h // Bm.shape[2]
    xf = x.float().transpose(1, 2)                                   # [b,h,s,p]
    Bh = Bm.float().repeat_interleave(rep, dim=2).transpose(1, 2)    # [b,h,s,n]
    Ch = Cm.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    dtf = dt.float().transpose(1, 2)                                 # [b,h,s]
    state = torch.zeros((b, h, p, Bm.shape[3]))
    y = torch.empty((b, h, s, p))
    for c0 in range(0, s, CHUNK):
        c1 = min(c0 + CHUNK, s)
        xc, bc, cc, dc = xf[:, :, c0:c1], Bh[:, :, c0:c1], Ch[:, :, c0:c1], dtf[:, :, c0:c1]
        cum = (dc * A.float()[None, :, None]).cumsum(-1)
        lower = torch.ones((c1 - c0, c1 - c0), dtype=torch.bool).tril()
        diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(~lower, -torch.inf)
        m = ((cc @ bc.transpose(-1, -2)) * torch.exp(diff) * dc[..., None, :]).to(bf).float()
        off = cc @ state.to(bf).float().transpose(-1, -2)
        y[:, :, c0:c1] = torch.exp(cum)[..., None] * off + m @ xc
        w = dc * torch.exp(cum[..., -1:] - cum)
        bd = (bc * w[..., None]).to(bf).float()
        state = state * torch.exp(cum[..., -1])[..., None, None] + xc.transpose(-1, -2) @ bd
    return y.transpose(1, 2).to(bf), state


@pytest.mark.parametrize("dt_shift", [0.0, -3.0], ids=["dt-0.7", "dt-0.05"])
@pytest.mark.parametrize("g", [1, 2])
def test_tc_decomposition_matches_pallas_kernel_and_oracle(g, dt_shift):
    """The tc kernel's arithmetic, emulated on the CPU, on bf16 inputs at a
    mamba2-like shape (h 4, p 16, n 16, S 300: four full 64-step chunks and
    a ragged one, A from -1 to -16), against the Pallas kernel (interpret
    mode) and the exact recurrence on the same bf16-rounded values in fp32:
    y and the final state within 2e-2 of their max (a wrong decay, carry or
    rounding point moves them by O(1)).  At dt about 0.05 a slow head keeps
    most of its state across chunks, so the carry is checked, not only the
    diagonal blocks."""
    arrays = _ssd_inputs(10 + g, 1, 300, 4, 16, g, 16, A=-np.linspace(1.0, 16.0, 4),
                         dt_shift=dt_shift)
    arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    J, _ = _both(arrays)
    _, T = _both(arrays, "bfloat16")
    assert variant(T[0], T[3], T[4]) == "tc"
    y, state = _tc_emulation(*T)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert _rel(y, jax_ref.ssd_reference(*J)) < 2e-2
    x, dt, A, Bm, Cm = arrays
    padded = [np.pad(a, [(0, 0), (0, 20)] + [(0, 0)] * (a.ndim - 2)) for a in (x, dt, Bm, Cm)]
    y_kernel = jax_ssd_scan(*(jnp.asarray(a) for a in padded[:2]), jnp.asarray(A),
                            *(jnp.asarray(a) for a in padded[2:]), chunk=64)
    assert _rel(y, np.asarray(y_kernel)[:, :300]) < 2e-2
    _, state_model = jax_ssm.ssd_chunked(*(jnp.asarray(a) for a in padded[:2]), jnp.asarray(A),
                                         *(jnp.asarray(a) for a in padded[2:]), 64)
    assert _rel(state, state_model) < 2e-2


# ------------------------------------------------------------ the mixer
def _configs(dtype):
    return (jax_smoke_config(ARCH).reduced(dtype=dtype),
            get_smoke_config(ARCH).reduced(dtype=dtype))


def _jax_and_port(dtype):
    jcfg, tcfg = _configs(dtype)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jmodel, jparams, build_model(tcfg, "cpu"), tparams


def test_config_matches_jax():
    for port, ref_cfg in ((get_config(ARCH), jax_config(ARCH)),
                          (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref_cfg)
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.d_inner, full.ssm_heads, full.ssm_headdim,
            full.ssm_state, full.ssm_groups, full.ssm_chunk, full.conv_kernel, full.vocab_size,
            full.norm_eps) == (48, 1024, 2048, 32, 64, 128, 1, 256, 4, 50_280, 1e-5)


def test_params_from_jax_keeps_1d_mamba_parameters_fp32():
    _, _, _, tparams = _jax_and_port("bfloat16")
    p = tparams["blocks"][0]["mamba"]
    for name in ("A_log", "D", "dt_bias", "norm", "conv_b"):
        assert p[name].dtype == torch.float32 and p[name].ndim == 1, name
    for name in ("in_proj", "conv_w", "out_proj"):
        assert p[name].dtype == torch.bfloat16, name


@pytest.mark.parametrize("S", [20, 32], ids=["padded", "chunk-multiple"])
def test_mamba_mixer_matches_jax(S):
    """apply_mamba with its cache, then three decode_mamba steps, in fp32 at 1e-4."""
    jmodel, jparams, _, tparams = _jax_and_port("float32")
    jcfg, tcfg = jmodel.cfg, _configs("float32")[1]
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["l0"]["mamba"])
    tp = tparams["blocks"][0]["mamba"]
    x = np.random.default_rng(5).standard_normal((2, S + 3, jcfg.d_model), dtype=np.float32)
    jout, jcache = jax_ssm.apply_mamba(jp, jnp.asarray(x[:, :S]), jcfg, return_cache=True)
    tout, tcache = ssm.apply_mamba(tp, torch.from_numpy(x[:, :S]), tcfg, return_cache=True)
    assert _rel(tout, jout) < SSD_TOL
    for name in ("state", "conv"):
        assert tcache[name].shape == jcache[name].shape
        assert _rel(tcache[name], jcache[name]) < SSD_TOL, name
    assert _rel(ssm.apply_mamba(tp, torch.from_numpy(x[:, :S]), tcfg), jout) < SSD_TOL
    for t in range(S, S + 3):
        jout, jcache = jax_ssm.decode_mamba(jp, jnp.asarray(x[:, t:t + 1]), jcache, jcfg)
        tout, tcache = ssm.decode_mamba(tp, torch.from_numpy(x[:, t:t + 1]), tcache, tcfg)
        assert _rel(tout, jout) < SSD_TOL, t
        for name in ("state", "conv"):
            assert _rel(tcache[name], jcache[name]) < SSD_TOL, (t, name)


# ------------------------------------------------------------ end to end
def _round_matrices_to_bf16(params):
    """The values the port holds after params_from_jax in bf16 (matrices
    rounded to bf16, 1-D parameters fp32), as fp32, for the JAX model run in
    fp32.  The block leaves carry the scan's leading [reps] axis."""
    def rounded(min_ndim):
        return lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)
                                    if a.ndim >= min_ndim else a, np.float32)

    return {"embed": jax.tree.map(rounded(2), params["embed"]),
            "blocks": jax.tree.map(rounded(3), params["blocks"]),
            "final_norm": jax.tree.map(rounded(2), params["final_norm"])}


# bf16 against the JAX fp32 model on the same bf16-rounded parameters: the
# port rounds activations to bf16 between ops (about 4e-3 relative each)
# through 3 layers of in_proj, conv, gated norm and out_proj.  Measured on
# the CPU over prompts 20, 32 and 48 and two token seeds: 0.7e-2 to 1.9e-2
# in the logits (prefill and 4 decode steps), 1.1e-2 to 2.5e-2 in the ssm
# cache.  5e-2 is twice the worst; a wrong decay, mask or state moves these
# by O(1).
BF16_VS_FP32_TOL = 5e-2


@pytest.mark.parametrize(
    "dtype,P,tol",
    [("float32", 20, 1e-4), ("float32", 32, 1e-4), ("bfloat16", 20, BF16_VS_FP32_TOL)],
    ids=["fp32-padded", "fp32-chunk-multiple", "bf16-vs-fp32"],
)
def test_serving_matches_jax_model(dtype, P, tol):
    """Prefill + 4 greedy decode steps against the JAX Model: logits, every
    layer's ssm cache, and (fp32) the greedy tokens."""
    jmodel, jparams, tmodel, tparams = _jax_and_port(dtype)
    if dtype == "bfloat16":
        jmodel = jax_build_model(jmodel.cfg.reduced(dtype="float32"))
        jparams = _round_matrices_to_bf16(jparams)
    B, steps = 2, 4
    tokens = np.random.default_rng(6).integers(0, jmodel.cfg.vocab_size, (B, P))
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tlogits, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    assert tlogits.shape == (B, 1, jmodel.cfg.vocab_size)
    empty = tmodel.init_cache(B, P + steps)
    assert [{k: v.shape for k, v in c["ssm"].items()} for c in empty] == \
        [{k: v.shape for k, v in c["ssm"].items()} for c in tcache]

    def check_caches():
        jlayers = cache_from_jax(jcache, jmodel.cfg)
        assert len(jlayers) == len(tcache) == jmodel.cfg.num_layers
        for jl, tl in zip(jlayers, tcache):
            for name in ("state", "conv"):
                assert _rel(tl["ssm"][name], jl["ssm"][name]) < tol, name

    check_caches()
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        assert _rel(tlogits, jlogits) < tol, f"step {i}"
        jtok = np.array(jnp.argmax(jlogits[:, -1], axis=-1))[:, None]
        if dtype == "float32":
            np.testing.assert_array_equal(tlogits[:, -1].argmax(-1, keepdim=True).numpy(), jtok)
        # Both sides continue from the reference's tokens, so a near tie cannot
        # fork the two sequences.
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(jtok, jnp.int32), jnp.int32(P + i))
        tlogits, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(jtok), P + i)
    assert _rel(tlogits, jlogits) < tol
    check_caches()


def test_cache_from_jax_keeps_the_ssm_layout():
    """ssm leaves are carried as they are (state [B,H,P,N], conv [B,K-1,C]),
    one entry per layer, where KV leaves are transposed."""
    jmodel = jax_build_model(jax_smoke_config(ARCH))
    rng = np.random.default_rng(7)
    jcache = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                          jmodel.init_cache(2, 8))
    layers_ = cache_from_jax(jcache, jmodel.cfg)
    seg = jcache[0]["l0"]["ssm"]
    assert len(layers_) == jmodel.cfg.num_layers
    for r, layer in enumerate(layers_):
        assert set(layer) == {"ssm"}
        for name in ("state", "conv"):
            np.testing.assert_array_equal(layer["ssm"][name].numpy(), seg[name][r])


def test_cpu_serving_launches_no_kernel():
    ops.reset_launch_counts()
    gen = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "20", "--gen", "4"])
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


def test_gated_norm_goes_through_the_rmsnorm_op(monkeypatch):
    """The gated norm (width d_inner) and ln1 both reach ops.fused_rmsnorm,
    the RMSNorm kernel's entry point, as do the decode step's."""
    _, _, tmodel, tparams = _jax_and_port("float32")
    widths = []
    real = ops.fused_rmsnorm

    def spy(x, scale, *, eps=1e-6):
        widths.append(x.shape[-1])
        return real(x, scale, eps=eps)

    monkeypatch.setattr(ops, "fused_rmsnorm", spy)
    cfg = tmodel.cfg
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 5)))
    _, cache = tmodel.prefill(tparams, {"tokens": tokens})
    per_forward = [cfg.d_model, cfg.d_inner] * cfg.num_layers + [cfg.d_model]
    assert widths == per_forward
    widths.clear()
    tmodel.decode_step(tparams, cache, tokens[:, :1], 5)
    assert widths == per_forward


@pytest.mark.parametrize("P", [1, 2])
def test_prompt_shorter_than_the_conv_tail_serves(P):
    """Prompts of 1 and 2 tokens, shorter than conv_kernel - 1 = 3: the conv
    tail is left-padded with zeros, and each of 4 decode steps gives the
    last-position logits of a prefill over the same tokens (fp32, 1e-5)."""
    cfg = get_smoke_config(ARCH).reduced(dtype="float32")
    assert P < cfg.conv_kernel - 1
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    B, steps = 2, 4
    tokens = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (B, P + steps)))
    logits, cache = model.prefill(params, {"tokens": tokens[:, :P]}, max_seq=P + steps)
    for c in cache:
        assert c["ssm"]["conv"].shape == (B, cfg.conv_kernel - 1, ssm._dims(cfg)[-1])
    for i in range(steps):
        logits, cache = model.decode_step(params, cache, tokens[:, P + i:P + i + 1], P + i)
        want, _ = model.prefill(params, {"tokens": tokens[:, :P + i + 1]})
        assert _rel(logits[:, -1], want[:, -1]) < 1e-5, i
