"""The port's encoder-decoder (whisper-large-v3: the audio stub's frames,
sinusoidal positions, an unmasked encoder, cross attention) against the
JAX package's ``EncDecModel`` on the CPU.

The JAX ``EncDecModel.init`` parameters, with every norm scale, norm bias
and FFN bias drawn at random in place of init's ones and zeros (so that one
applied to the wrong tensor shows), are carried into the port with
``params_from_jax``; both sides get the same numpy frames and prompts: the
position tables, LayerNorm, the GELU FFN, cross attention, ``encode``,
prefill logits with every layer's self and cross caches (through
``cache_from_jax``), and four decode steps.  Also: the full config's shapes
and cache bytes, the specs, which kernels a forward reaches, the tracer's
price of unmasked flash, the entry point with and without plans, and that
the smoke loss runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import specs as jax_specs
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro_torch.configs import get_config, get_smoke_config, specs
from repro_torch.core.trace import trace_step_fn
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.steps import build_serve_step
from repro_torch.models import attention, build_model, encdec, layers
from repro_torch.models.convert import cache_from_jax, params_from_jax, unstack_program
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import init_program_cache
from repro_torch.tree import map_tree, tree_leaves

ARCH = "whisper-large-v3"
# The serve tests' fp32 tolerance, relative to max|want|.
FP32_TOL = 1e-5
# The port in bf16 against the JAX model in fp32 on the same bf16-rounded
# weights, as tests/test_torch_hybrid.py holds hymba's (BF16_VS_FP32_TOL):
# what is left is the port's rounding of activations to bf16 between ops.
BF16_VS_FP32_TOL = 5e-2


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _random_vectors(params, seed: int):
    """``params`` with every norm scale drawn from 1 + N(0, 0.09), and every
    norm bias and FFN bias from N(0, 0.09), in place of init's ones and
    zeros."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']"):
            return (1.0 + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        if key.endswith("['bias']") or key.endswith("['b_up']") or key.endswith("['b_down']"):
            return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, params)


def _round_matrices_to_bf16(params):
    """The values the port holds after ``params_from_jax`` in bf16 (matrices
    rounded to bf16, vectors fp32), as fp32.  Both stacks are one segment
    repeated, so their leaves carry the scan's [reps] axis: a matrix there
    has three dimensions or more."""
    def rounded(min_ndim):
        return lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)
                                    if a.ndim >= min_ndim else a, np.float32)

    return {name: jax.tree.map(rounded(3 if name in ("encoder", "decoder") else 2), tree)
            for name, tree in params.items()}


def _models(dtype: str = "float32", seed: int = 0):
    jcfg = jax_smoke_config(ARCH).reduced(dtype=dtype)
    tcfg = get_smoke_config(ARCH).reduced(dtype=dtype)
    jmodel = jax_build_model(jcfg)
    jparams = _random_vectors(jmodel.init(jax.random.PRNGKey(seed)), seed + 7)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jmodel, jparams, build_model(tcfg, "cpu"), tparams, tcfg


def _frames(cfg, B: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, cfg.enc_seq, cfg.d_model),
                                                       dtype=np.float32)


# ------------------------------------------------------------- the config
def test_config_matches_jax():
    for port, ref_cfg in ((get_config(ARCH), jax_config(ARCH)),
                          (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref_cfg)
    full = get_config(ARCH)
    assert (full.num_layers, len(full.enc_program[0][0]) * full.enc_program[0][1],
            full.d_model, full.num_heads, full.num_kv_heads, full.head_dim, full.d_ff,
            full.vocab_size, full.enc_seq, full.frontend, full.norm_type, full.ffn_act) == \
        (32, 32, 1280, 20, 20, 64, 5120, 51_866, 1500, "audio_stub", "layer", "gelu")
    assert isinstance(build_model(full, "cpu"), encdec.EncDecModel)


def test_full_config_shapes_match_the_reference():
    """``EncDecModel.init_shapes()`` of the full config, on meta tensors,
    against the reference's ``eval_shape`` leaf for leaf (both stacks
    unstacked): norms and biases fp32, matrices bf16; 1,535,219,200
    parameters, 3,072,087,040 B as stored."""
    from torch.utils._pytree import tree_flatten_with_path

    class Shape:  # a leaf whose [r] drops the stacked axis, as unstack_program reads it
        def __init__(self, shape):
            self.shape = tuple(shape)

        def __getitem__(self, r):
            return Shape(self.shape[1:])

    cfg = get_config(ARCH)
    jshapes = jax.tree.map(lambda a: Shape(a.shape),
                           jax_build_model(jax_config(ARCH)).init_shapes())
    jshapes = dict(jshapes, encoder=unstack_program(jshapes["encoder"], cfg.enc_program),
                   decoder=unstack_program(jshapes["decoder"], cfg.program))
    tparams = build_model(cfg, "cpu").init_shapes()

    def paths(tree):
        leaves, _ = tree_flatten_with_path(tree, is_leaf=lambda a: isinstance(a, Shape))
        return {str(path): leaf for path, leaf in leaves}

    want = paths(jshapes)
    got = paths(map_tree(lambda t: Shape(t.shape), tparams))
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in want), \
        [k for k in want if got[k].shape != want[k].shape]
    for key, t in paths(tparams).items():
        assert t.dtype == (torch.float32 if t.ndim < 2 else torch.bfloat16), key
        assert t.device.type == "meta", key
    assert sum(t.numel() for t in tree_leaves(tparams)) == 1_535_219_200
    assert sum(t.numel() * t.element_size() for t in tree_leaves(tparams)) == 3_072_087_040


def test_serving_cache_bytes_by_kind():
    """The served cache at B4, prompt 128 + 32 tokens: 32 decoder layers of
    self K/V over 160 positions (104,857,600 B) and of cross K/V over the
    1500 frames (983,040,000 B), head-major, bf16."""
    cfg = get_config(ARCH)
    cache = init_program_cache(cfg, cfg.program, 4, 160, dtype_of(cfg), "meta")
    assert len(cache) == 32 and all(layer.keys() == {"kv", "enc_kv"} for layer in cache)
    assert all(tuple(t.shape) == (4, 20, 1500, 64) for layer in cache
               for t in layer["enc_kv"].values())
    nbytes = {kind: sum(t.numel() * t.element_size() for layer in cache
                        for t in layer[kind].values()) for kind in ("kv", "enc_kv")}
    assert nbytes == {"kv": 104_857_600, "enc_kv": 983_040_000}
    assert sum(nbytes.values()) == 1_087_897_600


def test_specs_match_the_reference():
    """A prefill cell takes the frames in the activation dtype beside the
    tokens, as the reference's specs say; a decode cell's cache holds the
    cross K/V.  A vision cell (qwen2-vl-7b) takes 1024 patch embeddings in
    the activation dtype, the text tokens that fill the rest of the
    sequence and [3, B, S] positions, int64 where the reference's are
    int32, its train cell labels of the tokens' shape."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    got = specs.input_specs(cfg, "prefill_32k")["batch"]
    want = jax_specs.input_specs(jcfg, "prefill_32k")["batch"]
    assert got.keys() == want.keys() == {"frames", "tokens"}
    assert tuple(got["frames"].shape) == want["frames"].shape == (32, 1500, 1280)
    assert got["frames"].dtype == torch.bfloat16 and got["frames"].device.type == "meta"
    assert tuple(got["tokens"].shape) == want["tokens"].shape
    smoke = get_smoke_config(ARCH)
    cache = specs.cache_specs(build_model(smoke, "cpu"), smoke, "decode_32k")
    assert all(tuple(t.shape) == (128, smoke.num_kv_heads, smoke.enc_seq, smoke.head_dim)
               for layer in cache for t in layer["enc_kv"].values())
    vl, jvl = get_config("qwen2-vl-7b"), jax_config("qwen2-vl-7b")
    for shape in ("prefill_32k", "train_4k"):
        got = specs.input_specs(vl, shape)["batch"]
        want = jax_specs.input_specs(jvl, shape)["batch"]
        assert got.keys() == want.keys()
        assert {k: tuple(t.shape) for k, t in got.items()} == \
            {k: tuple(t.shape) for k, t in want.items()}
        B, S = specs.SHAPES[shape].global_batch, specs.SHAPES[shape].seq_len
        assert tuple(got["tokens"].shape) == (B, S - 1024)
        assert tuple(got["patch_embeds"].shape) == (B, 1024, 3584)
        assert tuple(got["positions"].shape) == (3, B, S)
        assert {k: t.dtype for k, t in got.items()} == {
            k: torch.bfloat16 if k == "patch_embeds" else torch.long for k in want}


# ------------------------------------------------------ module by module
@pytest.mark.parametrize("pos0,seq", [(0, 24), (5, 9), (440, 8)])
def test_sinusoid_matches_jax(pos0, seq):
    """The table rows [pos0, pos0 + seq) equal the reference's table sliced at
    pos0, and decode's fp32 row at each of those positions (a 0-d tensor)
    equals the reference's decode row."""
    d = 64
    want = np.asarray(jax_encdec.sinusoid(pos0 + seq, d, jnp.float32))[pos0:]
    got = encdec.sinusoid(pos0, seq, d, torch.float32)
    assert got.shape == (seq, d) and np.abs(got.numpy() - want).max() <= 1e-7
    i = jnp.arange(d // 2, dtype=jnp.float32)
    for pos in (pos0, pos0 + seq - 1):
        ang = jnp.float32(pos) / (10000 ** (2 * i / d))
        row = np.asarray(jnp.concatenate([jnp.sin(ang), jnp.cos(ang)]))
        got = encdec.sinusoid_row(torch.tensor(pos), d, torch.float32).numpy()
        assert np.abs(got - row).max() <= 1e-5 * max(1, pos / 100)


@pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL), ("bfloat16", 2e-2)])
def test_layernorm_with_bias_matches_jax(dtype, tol):
    """Every LayerNorm of the smoke model (ln1, ln_cross, ln2 of a decoder
    layer, enc_norm, final_norm) on random scales and biases."""
    jmodel, jparams, _, tparams, tcfg = _models(dtype)
    jcfg = jmodel.cfg
    x = 3.0 * np.random.default_rng(1).standard_normal((2, 5, jcfg.d_model), dtype=np.float32)
    xj, xt = jnp.asarray(x, jcfg.dtype), torch.from_numpy(x).to(dtype_of(tcfg))
    jl = jax.tree.map(lambda a: a[1], jparams["decoder"][0]["l0"])
    pairs = [(tparams["decoder"][1][name], jl[name]) for name in ("ln1", "ln_cross", "ln2")]
    pairs += [(tparams[name], jparams[name]) for name in ("enc_norm", "final_norm")]
    for tp, jp in pairs:
        assert tp["bias"].dtype == torch.float32
        got = layers.apply_norm(tp, xt, tcfg)
        assert got.dtype == xt.dtype and _rel(got, jax_layers.apply_norm(jp, xj, jcfg)) < tol


def test_gelu_ffn_matches_jax_and_not_under_erf():
    """An encoder layer's GELU FFN with random biases in fp32: the port's
    (the tanh form) within FP32_TOL of the reference's, and the same FFN
    with the erf form (``F.gelu``'s default) more than ten times that away,
    so swapping the forms fails this test."""
    jmodel, jparams, _, tparams, tcfg = _models()
    jp = jax.tree.map(lambda a: a[0], jparams["encoder"][0]["l0"]["ffn"])
    tp = tparams["encoder"][0]["ffn"]
    x = 3.0 * np.random.default_rng(2).standard_normal((2, 7, tcfg.d_model), dtype=np.float32)
    want = jax_layers.apply_dense_ffn(jp, jnp.asarray(x), jmodel.cfg)
    xt = torch.from_numpy(x)
    assert _rel(layers.apply_dense_ffn(tp, xt, tcfg), want) < FP32_TOL
    h = F.gelu(xt @ tp["w_up"] + tp["b_up"])  # the erf form
    assert _rel(h @ tp["w_down"] + tp["b_down"], want) > 10 * FP32_TOL


@pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL), ("bfloat16", 2e-2)])
def test_cross_attention_matches_jax(dtype, tol):
    """A decoder layer's cross attention: over a prompt of 7 against the 24
    encoder positions through the flash operator, unmasked (Sq != Sk), and
    one decode token against the head-major cross cache, each against the
    reference's ``apply_cross_attention``; the cache against its K/V."""
    jmodel, jparams, _, tparams, tcfg = _models(dtype)
    jcfg = jmodel.cfg
    jp = jax.tree.map(lambda a: a[0], jparams["decoder"][0]["l0"]["cross"])
    tp = tparams["decoder"][0]["cross"]
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, jcfg.enc_seq, jcfg.d_model), dtype=np.float32)
    x = rng.standard_normal((2, 7, jcfg.d_model), dtype=np.float32)
    dt = dtype_of(tcfg)
    jkv = jax_attention.encode_cross_kv(jp, jnp.asarray(enc, jcfg.dtype), jcfg)
    tkv = attention.encode_cross_kv(tp, torch.from_numpy(enc).to(dt), tcfg)
    for got, want in zip(tkv, jkv):
        assert got.is_contiguous() and _rel(got, want) < tol
    want = jax_attention.apply_cross_attention(jp, jnp.asarray(x, jcfg.dtype), jkv, jcfg)
    assert _rel(attention.apply_cross_attention(tp, torch.from_numpy(x).to(dt), tkv, tcfg),
                want) < tol
    cache = attention.cross_cache(tkv)
    assert tuple(cache["k"].shape) == (2, jcfg.num_kv_heads, jcfg.enc_seq, jcfg.head_dim)
    want = jax_attention.apply_cross_attention(jp, jnp.asarray(x[:, :1], jcfg.dtype), jkv, jcfg)
    got = attention.decode_cross_attention(tp, torch.from_numpy(x[:, :1]).to(dt), cache, tcfg)
    assert _rel(got, want) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL), ("bfloat16", 2e-2)])
def test_encode_matches_jax(dtype, tol):
    """The encoder (frames plus the sinusoid table, two unmasked layers, the
    final LayerNorm) against the reference's ``encode``."""
    jmodel, jparams, tmodel, tparams, tcfg = _models(dtype)
    frames = _frames(tcfg, 2, 4)
    want = jmodel.encode(jparams, jnp.asarray(frames))
    got = tmodel.encode(tparams, torch.from_numpy(frames))
    assert got.dtype == dtype_of(tcfg) and _rel(got, want) < tol


# ------------------------------------------------------------ end to end
@pytest.mark.parametrize("dtype,P,tol", [("float32", 12, FP32_TOL), ("float32", 5, FP32_TOL),
                                         ("bfloat16", 12, BF16_VS_FP32_TOL)],
                         ids=["fp32", "fp32-short-prompt", "bf16-vs-fp32"])
def test_serving_matches_jax_model(dtype, P, tol):
    """Prefill of B2 frames and a prompt of ``P`` tokens, then 4 decode
    steps: the logits after each, and every layer's self cache and cross
    cache after prefill and after the last step (the cross cache, written
    once at prefill, must not move).  Both sides decode the reference's
    tokens, so a near-tie cannot fork the sequences.  In bf16 the JAX model
    runs in fp32 on the bf16-rounded weights."""
    jmodel, jparams, tmodel, tparams, tcfg = _models(dtype, seed=1)
    if dtype == "bfloat16":
        jmodel = jax_build_model(jmodel.cfg.reduced(dtype="float32"))
        jparams = _round_matrices_to_bf16(jparams)
    B, steps = 2, 4
    max_seq = P + steps
    frames = _frames(tcfg, B, 5)
    tokens = np.random.default_rng(6).integers(0, tcfg.vocab_size, (B, P))
    jlogits, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_seq=max_seq))(
        jparams, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens, jnp.int32)})
    tlogits, tcache = tmodel.prefill(
        tparams, {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)},
        max_seq)
    assert tlogits.shape == (B, 1, tcfg.vocab_size)
    assert map_tree(lambda t: (tuple(t.shape), t.dtype), tmodel.init_cache(B, max_seq)) == \
        map_tree(lambda t: (tuple(t.shape), t.dtype), tcache)

    def check_caches(when):
        jlayers = cache_from_jax(jcache, jmodel.cfg)
        assert len(jlayers) == len(tcache) == tcfg.num_layers
        for i, (jl, tl) in enumerate(zip(jlayers, tcache)):
            assert jl.keys() == tl.keys() == {"kv", "enc_kv"}, i
            for kind in jl:
                for name in ("k", "v"):
                    err = _rel(tl[kind][name], jl[kind][name])
                    assert err < tol, (when, i, kind, name, err)

    check_caches("prefill")
    cross = [c["enc_kv"]["k"].clone() for c in tcache]
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        assert _rel(tlogits, jlogits) < tol, f"step {i}: {_rel(tlogits, jlogits)}"
        jtok = np.array(jnp.argmax(jlogits[:, -1], axis=-1))[:, None]
        if dtype == "float32":
            np.testing.assert_array_equal(tlogits[:, -1].argmax(-1, keepdim=True).numpy(), jtok)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(jtok, jnp.int32), jnp.int32(P + i))
        tlogits, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(jtok),
                                             torch.tensor(P + i))
    assert _rel(tlogits, jlogits) < tol, _rel(tlogits, jlogits)
    check_caches("decode")
    assert all(torch.equal(c["enc_kv"]["k"], k) for c, k in zip(tcache, cross))


# ------------------------------------------------------ kernels, tracing
def test_forward_reaches_flash_unmasked_and_no_rmsnorm(monkeypatch):
    """A prefill reaches ``ops.flash_mha`` in each encoder layer unmasked at
    Sq = Sk = enc_seq, and in each decoder layer twice: causal self
    attention over the prompt, then cross attention unmasked with the
    prompt's queries against enc_seq keys.  No RMSNorm runs (every norm is
    a LayerNorm); a decode step reaches neither kernel."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    calls = []
    real_flash = ops.flash_mha

    def norm(*args, **kwargs):
        raise AssertionError("an RMSNorm ran for a LayerNorm model")

    def flash(q, k, v, **kw):
        calls.append((kw["causal"], kw.get("window"), q.shape[1], k.shape[1]))
        return real_flash(q, k, v, **kw)

    monkeypatch.setattr(ops, "fused_rmsnorm", norm)
    monkeypatch.setattr(ops, "flash_mha", flash)
    P, Se = 10, cfg.enc_seq
    batch = serve.serve_batch(cfg, 2, P, 0, "cpu")
    assert batch["frames"].shape == (2, Se, cfg.d_model) and batch["frames"].dtype == torch.float32
    _, cache = model.prefill(params, batch, max_seq=12)
    assert calls == [(False, None, Se, Se)] * 2 + [(True, None, P, P), (False, None, P, Se)] * 2
    calls.clear()
    model.decode_step(params, cache, batch["tokens"][:, :1], P)
    assert calls == []


def test_tracer_prices_unmasked_flash_and_the_new_ops():
    """The fake-tensor tracer prices cross attention's unmasked flash at
    4 B H hd Sq Sk (every pair live), and GELU, sin and cos at their
    outputs' elements, as every elementwise op."""
    B, Sq, Sk, H, hd = 2, 5, 24, 4, 16

    def step(q, k, v, h, a):
        return ops.flash_mha(q, k, v, causal=False), F.gelu(h, approximate="tanh"), \
            torch.sin(a), torch.cos(a)

    def meta(*shape):
        return torch.empty(shape, device="meta")

    trace = trace_step_fn(step, meta(B, Sq, H, hd), meta(B, Sk, H, hd), meta(B, Sk, H, hd),
                          meta(3, 7), meta(11))
    flops = sorted(f for f, _ in trace.op_costs.values())
    assert flops == [11, 11, 21, 4 * B * H * hd * Sq * Sk]


def test_decode_trace_is_independent_of_pos():
    """The decode step (self and cross caches, the position row from the 0-d
    position) traced on fake tensors at two positions gives the same events
    and peak: nothing reads the position on the host."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    kv = init_program_cache(cfg, cfg.program, 2, 20, dtype_of(cfg), "meta")
    tok = torch.empty((2, 1), dtype=torch.long, device="meta")
    got = []
    for pos in (8, 18):
        tr = trace_step_fn(build_serve_step(model, cfg), model.init_shapes(), kv, tok,
                           torch.tensor(pos))
        got.append((tr.num_indices, len(tr.variables), tr.peak_load()))
    assert got[0] == got[1]


# ------------------------------------------------------- entry point, guards
def test_serve_whisper_smoke_with_and_without_plans(tmp_path, capsys):
    """``serve.main --arch whisper-large-v3 --smoke --device cpu``; with
    ``--plan --plan-cache`` the prefill (encoder included) and decode steps
    trace on fake tensors and solve, and a second run restores both plans;
    the greedy tokens are equal in all three runs."""
    def run(argv):
        ops.reset_launch_counts()
        gen = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "12", "--gen", "4"] + argv)
        assert not any(ops.launch_counts().values())
        return gen, capsys.readouterr().out

    cfg = get_smoke_config(ARCH)
    gen, _ = run([])
    assert gen.shape == (2, 4) and 0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size
    argv = ["--plan", "--plan-cache", str(tmp_path)]
    planned, out = run(argv)
    assert torch.equal(planned, gen)
    for role in ("prefill", "decode"):
        assert f"[plan] {role}: solved" in out, out
    again, out = run(argv)
    assert torch.equal(again, gen)
    for role in ("prefill", "decode"):
        assert f"[plan] {role}: restored from cache" in out, out
    assert len(list(tmp_path.glob("*.json"))) == 2


def test_encdec_training_raises():
    """The training guard is gone: the smoke loss runs and is a finite fp32
    scalar, with aux 0 (tests/test_torch_encdec_train.py holds it to the
    reference)."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"frames": torch.zeros((1, cfg.enc_seq, cfg.d_model)),
             "tokens": torch.zeros((1, 8), dtype=torch.long),
             "labels": torch.zeros((1, 8), dtype=torch.long)}
    loss, metrics = model.loss(params, batch)
    assert loss.shape == () and loss.dtype == torch.float32 and torch.isfinite(loss)
    assert float(metrics["ce"]) == float(loss) and float(metrics["aux"]) == 0.0
